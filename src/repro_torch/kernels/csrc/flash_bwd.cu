// Flash-attention backward, GQA, for Hopper (sm_90a).
//
// From q (B, Sq, H, hd), k (B, Sk, KVH, hd), v (B, Sk, KVH, hdv), the
// forward's output out (B, Sq, H, hdv), its row log-sum-exp lse (B, H,
// Sq; natural log, +inf for a row that sees no key) and dout = dL/dout,
// for every batch b and head h (kv head h / G):
//   P[s, n]  = exp(q_s . k_n / sqrt(hd) - lse_s)   (0 where masked)
//   D[s]     = sum_d dout[s, d] out[s, d]
//   dS[s, n] = P[s, n] (dout_s . v_n - D[s]) / sqrt(hd)
//   dq_s = sum_n dS[s, n] k_n
//   dk_n = sum over the G heads and s of dS[s, n] q_s
//   dv_n = sum over the G heads and s of P[s, n] dout_s
// with the forward's masks: query position qpos = q_offset + s; a causal
// call sees n <= qpos and, with a window, n > qpos - window.  hd = hdv
// in a GQA layer; MLA's prefill has q and k nope + rope wide against a
// narrower v (192 against 128 in DeepSeek-V2-Lite), and the scale is
// 1 / sqrt(hd), q and k's width.
//
// Replaces no Pallas kernel: the reference has no Pallas backward.  It
// is the counterpart of the jnp custom_vjp
// src/repro/models/layers.py::_flash_vjp_bwd (line 245), "the
// flash-attention recipe at the XLA level": the scores are recomputed
// tile by tile from the saved row statistics and contracted at once,
// never stored.  The forward saves lse (flash.cu, flash_sm90.cu) where
// the reference's VJP saves its per-chunk max and sum.
//
// What bounds it on an H100: the tensor cores.  Each (query, visible
// key) pair and head costs five products of 2 hd operations (S, dP, dV,
// dK, dQ) against nine arrays of B S H hd read or written once: about
// 2,000 operations a byte at the LM path's shape (S = 4,096, causal),
// far above the card's ridge (about 295 in bf16).  So bf16 runs every
// product on the tensor cores (mma.sync m16n8k16, bf16 operands, fp32
// accumulation) and rounds P and dS to bf16 for the products that take
// them, which the stated tolerance accounts for (kernels/ref.py).
//
// Design: no floating-point atomics, so the gradient is the same bits
// run after run, at the price of computing S and dP twice.  Three
// launches:
// 1. delta_kernel: D for every row, one warp a row (bytes).
// 2. dkdv_kernel: one block per (b, kv head, 64 keys), four warps of 16
//    keys.  K and V stay in shared memory; the block walks the folded
//    (position, head) rows that see its keys -- row R of a kv head's
//    Sq * G rows is position R / G, head kvh * G + R % G, so the G heads
//    of the group are one walk -- in tiles of 64 through a two-stage
//    cp.async ring (q, dout, lse, D), and accumulates dK and dV in fp32
//    registers, keys as the products' rows: S^T = K Q^T, dP^T = V dO^T,
//    dV += P^T dO, dK += dS^T Q.  Each is written once, rounded once.
// 3. dq_kernel: one block per (b, kv head, 64 folded rows), as the
//    forward's: q and dout stay in shared memory, K and V tiles stream
//    through a two-stage ring, dQ += dS K accumulates in registers.
// Tiles wholly outside every row's mask are skipped, tiles every row
// sees whole skip the per-score test.  Ragged Sq, Sk and widths below
// the padded ones are zero-filled in shared memory and masked.  The
// bf16 kernels are templates on the two padded widths (HDK for q and k,
// HDV for v and dout), instantiated at 32/32, 64/64, 128/128 and
// 192/128 (multiples of 8, q/k up to 192 and v up to 128); at 192/128 a
// thread holds dK (96 fp32) and dV (64) beside the two 16 x 64 score
// fragments (64), so that instance runs one block an SM with up to 255
// registers a thread.  Its Hopper design is flash_bwd_sm90.cu; this
// file serves fp32 and the bf16 pairs that one does not instantiate
// (the smoke configs' 24/16, say), and is the yardstick timed beside
// it.
//
// fp32 inputs never touch the tensor cores (no TF32): the same three
// passes on the CUDA cores, four threads to a key (dK, dV) or to a row
// (dQ), each owning a quarter of q/k's and of v's widths; their shared
// tiles are sized by each width's most (static shared memory holds
// 48 KB, which two 32 x 192 fp32 tiles would fill).
//
// Layout: every array contiguous; dq, dk, dv in the operands' type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // folded rows a tile
constexpr int BN = 64;          // keys a tile
constexpr int THREADS = 128;    // bf16 kernels: 4 warps of 16
constexpr int T32 = 256;        // fp32 kernels: 4 threads a key or row
constexpr int BQ32 = 32;        // rows (dkdv) or keys (dq) a fp32 tile
constexpr int HD_MAX = 192;     // widest q and k
constexpr int HDV_MAX = 128;    // widest v
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const void* q;      // (B, Sq, H, hd)
  const void* k;      // (B, Sk, KVH, hd)
  const void* v;      // (B, Sk, KVH, hdv)
  const void* o;      // (B, Sq, H, hdv)
  const void* dout;
  const float* lse;   // (B, H, Sq)
  float* delta;       // (B, H, Sq), written by delta_kernel
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Sk, H, KVH, hd, hdv;   // hd: q and k; hdv: v, out, dout
  int causal, window, q_offset;
  float scale;        // 1 / sqrt(hd)
  float scale_log2;   // log2(e) / sqrt(hd)
};

__device__ __forceinline__ bool visible(const Args& a, int n, int qpos) {
  if (n >= a.Sk) return false;
  if (!a.causal) return true;
  if (n > qpos) return false;
  return a.window <= 0 || n > qpos - a.window;
}

// The key tiles [*t0, *t1) of width bn that some row of rows
// [R0, R0 + bm) can see.
__device__ __forceinline__ void key_tiles(const Args& a, int G, int R0,
                                          int bm, int bn, int* t0, int* t1) {
  const int rows = a.Sq * G;
  const int R1 = min(R0 + bm, rows) - 1;
  int k0 = 0, k1 = a.Sk;
  if (a.causal) {
    const int pos_lo = a.q_offset + R0 / G;
    const int pos_hi = a.q_offset + R1 / G;
    k1 = max(0, min(a.Sk, pos_hi + 1));
    if (a.window > 0) k0 = max(0, pos_lo - a.window + 1);
  }
  *t0 = k0 / bn;
  *t1 = k1 > k0 ? (k1 + bn - 1) / bn : *t0;
}

// The row tiles [*t0, *t1) of height bm that some key of keys
// [n0, n0 + bn) is seen by.
__device__ __forceinline__ void row_tiles(const Args& a, int G, int n0,
                                          int bn, int bm, int* t0, int* t1) {
  const int n1 = min(n0 + bn, a.Sk) - 1;
  int p0 = 0, p1 = a.Sq - 1;               // positions, both included
  if (a.causal) {
    p0 = max(0, n0 - a.q_offset);
    if (a.window > 0) p1 = min(p1, n1 + a.window - 1 - a.q_offset);
  }
  if (n1 < n0 || p1 < p0) {
    *t0 = *t1 = 0;
    return;
  }
  *t0 = p0 * G / bm;
  *t1 = ((p1 + 1) * G + bm - 1) / bm;
}

// row index of lse and D for folded row R of (b, kvh)
__device__ __forceinline__ int64_t stat_index(const Args& a, int b, int kvh,
                                              int G, int R) {
  return ((int64_t)b * a.H + kvh * G + R % G) * a.Sq + R / G;
}

// element offset of folded row R of (b, kvh) in q and dq (width hd) or
// out and dout (width hdv)
__device__ __forceinline__ int64_t q_row(const Args& a, int b, int kvh,
                                         int G, int R, int width) {
  return (((int64_t)b * a.Sq + R / G) * a.H + kvh * G + R % G) * width;
}

// element offset of key n of (b, kvh) in k and dk (width hd) or v and dv
// (width hdv)
__device__ __forceinline__ int64_t k_row(const Args& a, int b, int kvh,
                                         int n, int width) {
  return (((int64_t)b * a.Sk + n) * a.KVH + kvh) * width;
}

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ---------------------------------------------------------------------
// D = rowsum(dout . out), fp32, one warp a (b, s, h) row
// ---------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256) delta_kernel(const Args a) {
  const int64_t row = blockIdx.x * 8LL + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t rows = (int64_t)a.B * a.Sq * a.H;
  if (row >= rows) return;
  const T* o = static_cast<const T*>(a.o) + row * a.hdv;
  const T* g = static_cast<const T*>(a.dout) + row * a.hdv;
  float acc = 0.f;
  for (int d = lane; d < a.hdv; d += 32)
    acc = fmaf(to_f(g[d]), to_f(o[d]), acc);
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = (int)(row % a.H);
    const int64_t bs = row / a.H;              // b * Sq + s
    const int64_t b = bs / a.Sq, s = bs % a.Sq;
    a.delta[(b * a.H + h) * a.Sq + s] = acc;
  }
}

// ---------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x, relative error about 2^-22 (below bf16's 2^-9); 2^-inf = 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 64 rows x HDP of one operand into shared rows of LD elements, 16-byte
// chunks, zeros where `ok_row` is false and past hd.  row_off(r) is the
// element offset of tile row r.
template <int HDP, typename RowOff, typename RowOk>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* base, int hd,
                                          RowOff row_off, RowOk ok_row) {
  constexpr int LD = HDP + 8;
  constexpr int CH = HDP / 8;
  for (int i = threadIdx.x; i < 64 * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const bool ok = ok_row(r) && c * 8 < hd;
    const __nv_bfloat16* src = ok ? base + row_off(r) + c * 8 : base;
    cp_async16(dst + r * LD + c * 8, src, ok ? 16 : 0);
  }
}

// The A fragments (16 x 16) of rows w16.. of a tile at k-step kk.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t* f, const __nv_bfloat16* t,
                                       int w16, int kk, int lane) {
  ldmatrix_x4(f, t + (w16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
}

// The B fragments of column tiles 2 np and 2 np + 1 at k-step kk, from a
// tile whose rows are the product's columns (S = A B^T).
template <int LD>
__device__ __forceinline__ void load_b(uint32_t* f, const __nv_bfloat16* t,
                                       int np, int kk, int lane) {
  ldmatrix_x4(f, t + (np * 16 + (lane / 16) * 8 + lane % 8) * LD + kk * 16 +
                     ((lane / 8) % 2) * 8);
}

// The B fragments of column tiles 2 dp and 2 dp + 1 at k-step kk, from a
// tile whose rows are the product's k dimension (C = A B).
template <int LD>
__device__ __forceinline__ void load_bt(uint32_t* f, const __nv_bfloat16* t,
                                        int dp, int kk, int lane) {
  ldmatrix_x4_trans(f, t + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LD +
                           dp * 16 + (lane / 16) * 8);
}

// acc (16 x HDP) += X (16 x 64, the C fragments x of a 16 x 64 product,
// rounded to bf16) times tile t (64 x HDP rows)
template <int HDP>
__device__ __forceinline__ void mma_xt(float (*acc)[4], float (*x)[4],
                                       const __nv_bfloat16* t, int lane) {
  constexpr int LD = HDP + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    pa[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    pa[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    pa[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int dp = 0; dp < HDP / 16; ++dp) {
      uint32_t f[4];
      load_bt<LD>(f, t, dp, kk, lane);
      mma_bf16(acc[2 * dp], pa, f[0], f[1]);
      mma_bf16(acc[2 * dp + 1], pa, f[2], f[3]);
    }
  }
}

// c (16 x 64) = rows w16.. of tile a (x HDP) times the 64 rows of tile b
template <int HDP>
__device__ __forceinline__ void mma_abt(float (*c)[4], const __nv_bfloat16* ta,
                                        const __nv_bfloat16* tb, int w16,
                                        int lane) {
  constexpr int LD = HDP + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    uint32_t af[4];
    load_a<LD>(af, ta, w16, kk, lane);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bf[4];
      load_b<LD>(bf, tb, np, kk, lane);
      mma_bf16(c[2 * np], af, bf[0], bf[1]);
      mma_bf16(c[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// write a warp's 16 x HDP fp32 accumulator as bf16 rows: row r of the
// fragment (lane / 4 and + 8) at element offset off(r), if ok(r)
template <int HDP, typename Off, typename Ok>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst,
                                           float (*acc)[4], int hd, int lane,
                                           Off off, Ok ok) {
  const int cq = 2 * (lane % 4);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = lane / 4 + 8 * half;
    if (!ok(r)) continue;
    const int64_t o = off(r);
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      const int d = j * 8 + cq;
      if (d < hd)
        *reinterpret_cast<__nv_bfloat162*>(dst + o + d) =
            __floats2bfloat162_rn(acc[j][2 * half], acc[j][2 * half + 1]);
    }
  }
}

// HDK: padded width of q and k, HDV: of v and dout; MINB blocks share
// an SM
template <int HDK, int HDV, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
    dkdv_bf16_kernel(const Args a) {
  constexpr int TILEK = 64 * (HDK + 8);   // a tile of 64 q or k rows
  constexpr int TILEV = 64 * (HDV + 8);   // of 64 v or dout rows
  constexpr int DTK = HDK / 8, DTV = HDV / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + TILEK;
  // stage s: q at sQ + s (TILEK + TILEV), dout after it
  __nv_bfloat16* sQ = sV + TILEV;
  float* sL = reinterpret_cast<float*>(sQ + 2 * (TILEK + TILEV));  // [2][BM]
  float* sD = sL + 2 * BM;                                          // [2][BM]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int G = a.H / a.KVH;
  const int b = blockIdx.y / a.KVH, kvh = blockIdx.y % a.KVH;
  const int rows = a.Sq * G;
  const int n0 = blockIdx.x * BN;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* g = static_cast<const __nv_bfloat16*>(a.dout);
  const int cq = 2 * (lane % 4);
  // this thread's two keys of every fragment
  const int nk_lo = n0 + warp * 16 + lane / 4, nk_hi = nk_lo + 8;

  float dk[DTK][4], dv[DTV][4];
#pragma unroll
  for (int j = 0; j < DTK; ++j) dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
#pragma unroll
  for (int j = 0; j < DTV; ++j) dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;

  int t0, t1;
  row_tiles(a, G, n0, BN, BM, &t0, &t1);
  // stage a row tile's q, dout (cp.async) and lse, D (plain stores)
  auto stage = [&](int t, int st) {
    const int R0 = t * BM;
    auto qoff = [&](int r) { return q_row(a, b, kvh, G, R0 + r, a.hd); };
    auto goff = [&](int r) { return q_row(a, b, kvh, G, R0 + r, a.hdv); };
    auto ok = [&](int r) { return R0 + r < rows; };
    __nv_bfloat16* tq = sQ + st * (TILEK + TILEV);
    load_tile<HDK>(tq, q, a.hd, qoff, ok);
    load_tile<HDV>(tq + TILEK, g, a.hdv, goff, ok);
    for (int r = threadIdx.x; r < BM; r += THREADS) {
      const int R = R0 + r;
      float l2 = INFINITY, d = 0.f;
      if (R < rows) {
        const int64_t i = stat_index(a, b, kvh, G, R);
        l2 = a.lse[i] * LOG2E;
        d = a.delta[i];
      }
      sL[st * BM + r] = l2;
      sD[st * BM + r] = d;
    }
  };
  if (t0 < t1) {
    auto koff = [&](int r) { return k_row(a, b, kvh, n0 + r, a.hd); };
    auto voff = [&](int r) { return k_row(a, b, kvh, n0 + r, a.hdv); };
    auto kok = [&](int r) { return n0 + r < a.Sk; };
    load_tile<HDK>(sK, static_cast<const __nv_bfloat16*>(a.k), a.hd, koff,
                   kok);
    load_tile<HDV>(sV, static_cast<const __nv_bfloat16*>(a.v), a.hdv, voff,
                   kok);
    stage(t0, 0);
    cp_async_commit();
  }
  const int n1 = n0 + BN - 1;
  for (int t = t0; t < t1; ++t) {
    const int st = (t - t0) & 1;
    if (t + 1 < t1) stage(t + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* tq = sQ + st * (TILEK + TILEV);
    const __nv_bfloat16* tg = tq + TILEK;
    const float* l2 = sL + st * BM;
    const float* dd = sD + st * BM;
    const int R0 = t * BM;
    const int bpos_lo = a.q_offset + R0 / G;
    const int bpos_hi = a.q_offset + (min(R0 + BM, rows) - 1) / G;
    const bool whole = n1 < a.Sk && visible(a, n1, bpos_lo) &&
                       visible(a, n0, bpos_hi);

    // P^T (16 keys x 64 rows) = exp2(K Q^T scale_log2 - lse2), masked
    float p[8][4];
    mma_abt<HDK>(p, sK, tq, warp * 16, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + cq + (e & 1);
        float x = ex2(fmaf(p[j][e], a.scale_log2, -l2[c]));
        if (!whole &&
            !visible(a, e < 2 ? nk_lo : nk_hi, a.q_offset + (R0 + c) / G))
          x = 0.f;
        p[j][e] = x;
      }
    }
    // dV += P^T dO
    mma_xt<HDV>(dv, p, tg, lane);
    // dS^T = P^T (V dO^T - D) scale;  dK += dS^T Q
    float ds[8][4];
    mma_abt<HDV>(ds, sV, tg, warp * 16, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[j][e] = p[j][e] * (ds[j][e] - dd[j * 8 + cq + (e & 1)]) * a.scale;
    mma_xt<HDK>(dk, ds, tq, lane);
    __syncthreads();   // before the next iteration refills this stage
  }

  auto koff = [&](int r) {
    return k_row(a, b, kvh, n0 + warp * 16 + r, a.hd);
  };
  auto voff = [&](int r) {
    return k_row(a, b, kvh, n0 + warp * 16 + r, a.hdv);
  };
  auto ok = [&](int r) { return n0 + warp * 16 + r < a.Sk; };
  store_rows<HDK>(static_cast<__nv_bfloat16*>(a.dk), dk, a.hd, lane, koff,
                  ok);
  store_rows<HDV>(static_cast<__nv_bfloat16*>(a.dv), dv, a.hdv, lane, voff,
                  ok);
}

template <int HDK, int HDV, int MINB>
__global__ void __launch_bounds__(THREADS, MINB) dq_bf16_kernel(const Args a) {
  constexpr int TILEK = 64 * (HDK + 8);
  constexpr int TILEV = 64 * (HDV + 8);
  constexpr int DT = HDK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sG = sQ + TILEK;
  // stage s: K at s (TILEK + TILEV), V after it
  __nv_bfloat16* sKV = sG + TILEV;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int G = a.H / a.KVH;
  const int b = blockIdx.y / a.KVH, kvh = blockIdx.y % a.KVH;
  const int rows = a.Sq * G;
  // the latest rows walk the most key tiles: their blocks go first
  const int R0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(a.v);
  const int cq = 2 * (lane % 4);
  const int r_lo = R0 + warp * 16 + lane / 4, r_hi = r_lo + 8;
  const int qpos_lo = a.q_offset + r_lo / G;
  const int qpos_hi = a.q_offset + r_hi / G;
  float l2_lo = INFINITY, l2_hi = INFINITY, d_lo = 0.f, d_hi = 0.f;
  if (r_lo < rows) {
    const int64_t i = stat_index(a, b, kvh, G, r_lo);
    l2_lo = a.lse[i] * LOG2E;
    d_lo = a.delta[i];
  }
  if (r_hi < rows) {
    const int64_t i = stat_index(a, b, kvh, G, r_hi);
    l2_hi = a.lse[i] * LOG2E;
    d_hi = a.delta[i];
  }

  float dq[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  int t0, t1;
  key_tiles(a, G, R0, BM, BN, &t0, &t1);
  auto stage = [&](int t, int st) {
    auto koff = [&](int r) { return k_row(a, b, kvh, t * BN + r, a.hd); };
    auto voff = [&](int r) { return k_row(a, b, kvh, t * BN + r, a.hdv); };
    auto ok = [&](int r) { return t * BN + r < a.Sk; };
    __nv_bfloat16* tk = sKV + st * (TILEK + TILEV);
    load_tile<HDK>(tk, kb, a.hd, koff, ok);
    load_tile<HDV>(tk + TILEK, vb, a.hdv, voff, ok);
  };
  if (t0 < t1) {
    auto qoff = [&](int r) { return q_row(a, b, kvh, G, R0 + r, a.hd); };
    auto goff = [&](int r) { return q_row(a, b, kvh, G, R0 + r, a.hdv); };
    auto ok = [&](int r) { return R0 + r < rows; };
    load_tile<HDK>(sQ, static_cast<const __nv_bfloat16*>(a.q), a.hd, qoff,
                   ok);
    load_tile<HDV>(sG, static_cast<const __nv_bfloat16*>(a.dout), a.hdv,
                   goff, ok);
    stage(t0, 0);
    cp_async_commit();
  }
  const int bpos_lo = a.q_offset + R0 / G;
  const int bpos_hi = a.q_offset + (min(R0 + BM, rows) - 1) / G;
  for (int t = t0; t < t1; ++t) {
    const int st = (t - t0) & 1;
    if (t + 1 < t1) stage(t + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* tk = sKV + st * (TILEK + TILEV);
    const __nv_bfloat16* tv = tk + TILEK;
    const int n0 = t * BN, n1 = n0 + BN - 1;
    const bool whole = n1 < a.Sk && visible(a, n1, bpos_lo) &&
                       visible(a, n0, bpos_hi);

    // P (16 rows x 64 keys) = exp2(Q K^T scale_log2 - lse2), masked
    float p[8][4];
    mma_abt<HDK>(p, sQ, tk, warp * 16, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e >= 2;
        float x = ex2(fmaf(p[j][e], a.scale_log2, hi ? -l2_hi : -l2_lo));
        if (!whole && !visible(a, n0 + j * 8 + cq + (e & 1),
                               hi ? qpos_hi : qpos_lo))
          x = 0.f;
        p[j][e] = x;
      }
    }
    // dS = P (dO V^T - D) scale;  dQ += dS K
    float ds[8][4];
    mma_abt<HDV>(ds, sG, tv, warp * 16, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[j][e] = p[j][e] * (ds[j][e] - (e >= 2 ? d_hi : d_lo)) * a.scale;
    mma_xt<HDK>(dq, ds, tk, lane);
    __syncthreads();   // before the next iteration refills this stage
  }

  auto off = [&](int r) {
    return q_row(a, b, kvh, G, R0 + warp * 16 + r, a.hd);
  };
  auto ok = [&](int r) { return R0 + warp * 16 + r < rows; };
  store_rows<HDK>(static_cast<__nv_bfloat16*>(a.dq), dq, a.hd, lane, off, ok);
}

// ---------------------------------------------------------------------
// fp32: CUDA cores, no TF32
// ---------------------------------------------------------------------

// 4 threads a key, 64 keys a block; rows of q and dout staged 32 at a time
__global__ void __launch_bounds__(T32) dkdv_f32_kernel(const Args a) {
  __shared__ float sq[BQ32][HD_MAX];
  __shared__ float sg[BQ32][HDV_MAX];
  __shared__ float sl[BQ32], sd[BQ32];
  constexpr int DQ = HD_MAX / 4;     // most q/k dims a thread owns
  constexpr int DV = HDV_MAX / 4;    // most v dims a thread owns
  const int G = a.H / a.KVH;
  const int b = blockIdx.y / a.KVH, kvh = blockIdx.y % a.KVH;
  const int rows = a.Sq * G;
  const int n0 = blockIdx.x * BN;
  const int n = n0 + threadIdx.x / 4;      // this thread's key
  const int t4 = threadIdx.x % 4;          // it owns dims t4 + 4 i
  const int nd = a.hd / 4, ndv = a.hdv / 4;
  const float* q = static_cast<const float*>(a.q);
  const float* g = static_cast<const float*>(a.dout);

  float kr[DQ], vr[DV], dk[DQ], dv[DV];
  const int64_t koff = k_row(a, b, kvh, min(n, a.Sk - 1), a.hd);
  const int64_t voff = k_row(a, b, kvh, min(n, a.Sk - 1), a.hdv);
#pragma unroll
  for (int i = 0; i < DQ; ++i) {
    const bool ok = i < nd && n < a.Sk;
    kr[i] = ok ? static_cast<const float*>(a.k)[koff + t4 + 4 * i] : 0.f;
    dk[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < DV; ++i) {
    const bool ok = i < ndv && n < a.Sk;
    vr[i] = ok ? static_cast<const float*>(a.v)[voff + t4 + 4 * i] : 0.f;
    dv[i] = 0.f;
  }

  int t0, t1;
  row_tiles(a, G, n0, BN, BQ32, &t0, &t1);
  for (int t = t0; t < t1; ++t) {
    const int R0 = t * BQ32;
    for (int i = threadIdx.x; i < BQ32 * a.hd; i += T32) {
      const int r = i / a.hd, d = i % a.hd, R = R0 + r;
      const bool ok = R < rows;
      sq[r][d] = ok ? q[q_row(a, b, kvh, G, R, a.hd) + d] : 0.f;
    }
    for (int i = threadIdx.x; i < BQ32 * a.hdv; i += T32) {
      const int r = i / a.hdv, d = i % a.hdv, R = R0 + r;
      const bool ok = R < rows;
      sg[r][d] = ok ? g[q_row(a, b, kvh, G, R, a.hdv) + d] : 0.f;
    }
    for (int r = threadIdx.x; r < BQ32; r += T32) {
      const int R = R0 + r;
      const bool ok = R < rows;
      const int64_t i = ok ? stat_index(a, b, kvh, G, R) : 0;
      sl[r] = ok ? a.lse[i] * LOG2E : INFINITY;
      sd[r] = ok ? a.delta[i] : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < BQ32; ++r) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < DQ; ++i)
        if (i < nd) s = fmaf(kr[i], sq[r][t4 + 4 * i], s);
#pragma unroll
      for (int i = 0; i < DV; ++i)
        if (i < ndv) dp = fmaf(vr[i], sg[r][t4 + 4 * i], dp);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 2);
      const int R = R0 + r;
      const float p = R < rows && visible(a, n, a.q_offset + R / G)
                          ? exp2f(fmaf(s, a.scale_log2, -sl[r]))
                          : 0.f;
      const float ds = p * (dp - sd[r]) * a.scale;
#pragma unroll
      for (int i = 0; i < DV; ++i)
        if (i < ndv) dv[i] = fmaf(p, sg[r][t4 + 4 * i], dv[i]);
#pragma unroll
      for (int i = 0; i < DQ; ++i)
        if (i < nd) dk[i] = fmaf(ds, sq[r][t4 + 4 * i], dk[i]);
    }
    __syncthreads();
  }
  if (n < a.Sk) {
    float* dkp = static_cast<float*>(a.dk) + koff;
    float* dvp = static_cast<float*>(a.dv) + voff;
#pragma unroll
    for (int i = 0; i < DQ; ++i)
      if (i < nd) dkp[t4 + 4 * i] = dk[i];
#pragma unroll
    for (int i = 0; i < DV; ++i)
      if (i < ndv) dvp[t4 + 4 * i] = dv[i];
  }
}

// 4 threads a folded row, 64 rows a block; keys staged 32 at a time
__global__ void __launch_bounds__(T32) dq_f32_kernel(const Args a) {
  __shared__ float sk[BQ32][HD_MAX];
  __shared__ float sv[BQ32][HDV_MAX];
  constexpr int DQ = HD_MAX / 4;
  constexpr int DV = HDV_MAX / 4;
  const int G = a.H / a.KVH;
  const int b = blockIdx.y / a.KVH, kvh = blockIdx.y % a.KVH;
  const int rows = a.Sq * G;
  const int R0 = blockIdx.x * BM;
  const int R = R0 + threadIdx.x / 4;
  const int t4 = threadIdx.x % 4;
  const int nd = a.hd / 4, ndv = a.hdv / 4;
  const int qpos = a.q_offset + R / G;
  const float* kb = static_cast<const float*>(a.k);
  const float* vb = static_cast<const float*>(a.v);

  float qr[DQ], gr[DV], dq[DQ];
  const int64_t qoff = q_row(a, b, kvh, G, min(R, rows - 1), a.hd);
  const int64_t goff = q_row(a, b, kvh, G, min(R, rows - 1), a.hdv);
#pragma unroll
  for (int i = 0; i < DQ; ++i) {
    const bool ok = i < nd && R < rows;
    qr[i] = ok ? static_cast<const float*>(a.q)[qoff + t4 + 4 * i] : 0.f;
    dq[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < DV; ++i) {
    const bool ok = i < ndv && R < rows;
    gr[i] = ok ? static_cast<const float*>(a.dout)[goff + t4 + 4 * i] : 0.f;
  }
  float l2 = INFINITY, dd = 0.f;
  if (R < rows) {
    const int64_t i = stat_index(a, b, kvh, G, R);
    l2 = a.lse[i] * LOG2E;
    dd = a.delta[i];
  }

  int t0, t1;
  key_tiles(a, G, R0, BM, BQ32, &t0, &t1);
  for (int t = t0; t < t1; ++t) {
    for (int i = threadIdx.x; i < BQ32 * a.hd; i += T32) {
      const int r = i / a.hd, d = i % a.hd, n = t * BQ32 + r;
      sk[r][d] = n < a.Sk ? kb[k_row(a, b, kvh, n, a.hd) + d] : 0.f;
    }
    for (int i = threadIdx.x; i < BQ32 * a.hdv; i += T32) {
      const int r = i / a.hdv, d = i % a.hdv, n = t * BQ32 + r;
      sv[r][d] = n < a.Sk ? vb[k_row(a, b, kvh, n, a.hdv) + d] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < BQ32; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < DQ; ++i)
        if (i < nd) s = fmaf(qr[i], sk[j][t4 + 4 * i], s);
#pragma unroll
      for (int i = 0; i < DV; ++i)
        if (i < ndv) dp = fmaf(gr[i], sv[j][t4 + 4 * i], dp);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 2);
      const float p = R < rows && visible(a, t * BQ32 + j, qpos)
                          ? exp2f(fmaf(s, a.scale_log2, -l2))
                          : 0.f;
      const float ds = p * (dp - dd) * a.scale;
#pragma unroll
      for (int i = 0; i < DQ; ++i)
        if (i < nd) dq[i] = fmaf(ds, sk[j][t4 + 4 * i], dq[i]);
    }
    __syncthreads();
  }
  if (R < rows) {
    float* out = static_cast<float*>(a.dq) + qoff;
#pragma unroll
    for (int i = 0; i < DQ; ++i)
      if (i < nd) out[t4 + 4 * i] = dq[i];
  }
}

// HDK, HDV: the padded widths of q/k and of v; MINB blocks share an SM
template <int HDK, int HDV, int MINB>
cudaError_t launch_bf16(const Args& a, dim3 gk, dim3 gq, cudaStream_t st) {
  constexpr int pair_bytes = 64 * (HDK + 8 + HDV + 8) * 2;   // q|k + v|dout
  constexpr int kv_bytes = 3 * pair_bytes + 4 * BM * 4;       // + lse, D x 2
  constexpr int q_bytes = 3 * pair_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_bf16_kernel<HDK, HDV, MINB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kv_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_bf16_kernel<HDK, HDV, MINB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             q_bytes);
  if (err != cudaSuccess) return err;
  if (gk.x > 0)
    dkdv_bf16_kernel<HDK, HDV, MINB><<<gk, THREADS, kv_bytes, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (gq.x > 0) dq_bf16_kernel<HDK, HDV, MINB><<<gq, THREADS, q_bytes, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q, dq (B, Sq, H, hd); out, dout (B, Sq, H, hdv); k, dk (B, Sk, KVH,
// hd); v, dv (B, Sk, KVH, hdv); lse and delta (B, H, Sq) fp32, delta a
// scratch buffer this call writes; all contiguous device pointers.
// is_bf16 picks the tensor-core kernels, else fp32.  A width above 192
// (q, k) or 128 (v) is refused.  The caller has checked shapes, hd % 8
// == hdv % 8 == 0, the 16-byte alignment of bf16 pointers, B * KVH <=
// 65535, and 0 <= q_offset, 0 <= window.
extern "C" int flash_bwd(const void* q, const void* k, const void* v,
                         const void* out, const void* dout, const void* lse,
                         void* delta, void* dq, void* dk, void* dv,
                         int64_t B, int64_t Sq, int64_t Sk, int64_t H,
                         int64_t KVH, int64_t hd, int64_t hdv,
                         int64_t causal, int64_t window, int64_t q_offset,
                         int64_t is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (hd > HD_MAX || hdv > HDV_MAX) return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = out;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.B = (int)B;
  a.Sq = (int)Sq;
  a.Sk = (int)Sk;
  a.H = (int)H;
  a.KVH = (int)KVH;
  a.hd = (int)hd;
  a.hdv = (int)hdv;
  a.causal = (int)causal;
  a.window = (int)window;
  a.q_offset = (int)q_offset;
  a.scale = (float)(1.0 / sqrt((double)hd));
  a.scale_log2 = (float)(1.4426950408889634 / sqrt((double)hd));
  const int64_t rows = Sq * (H / KVH);
  const int64_t n_rows = B * Sq * H;
  // a call with no key has dq 0 and one with no query dk, dv 0: the
  // kernels write those zeros from empty walks; a grid of no blocks is
  // not launched
  cudaError_t err = cudaSuccess;
  if (n_rows > 0) {
    const unsigned blocks = (unsigned)((n_rows + 7) / 8);
    if (is_bf16)
      delta_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(a);
    else
      delta_kernel<float><<<blocks, 256, 0, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 gk((unsigned)((Sk + BN - 1) / BN), (unsigned)(B * KVH));
  const dim3 gq((unsigned)((rows + BM - 1) / BM), (unsigned)(B * KVH));
  if (!is_bf16) {
    if (gk.x > 0) dkdv_f32_kernel<<<gk, T32, 0, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (gq.x > 0) dq_f32_kernel<<<gq, T32, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  if (hd <= 32 && hdv <= 32) return (int)launch_bf16<32, 32, 2>(a, gk, gq, st);
  if (hd <= 64 && hdv <= 64) return (int)launch_bf16<64, 64, 2>(a, gk, gq, st);
  if (hd <= 128 && hdv <= 128)
    return (int)launch_bf16<128, 128, 2>(a, gk, gq, st);
  return (int)launch_bf16<HD_MAX, HDV_MAX, 1>(a, gk, gq, st);
}
