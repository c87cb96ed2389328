// Flash-attention forward, GQA, for Hopper (sm_90a).
//
// For every batch b, query position s and head h (kv head h / G):
//   out[b, s, h] = sum_n p[n] v[b, n, h / G] / sum_n p[n],
//   p[n] = exp(q[b, s, h] . k[b, n, h / G] / sqrt(hd) - max)
// where q and k are hd wide and v is hdv wide (hd = hdv in a GQA layer;
// MLA's prefill has hd = nope + rope = 192 against hdv = 128)
// over the keys n the mask lets through: with qpos = q_offset + s, a
// causal call sees n <= qpos and, with a window, n > qpos - window; a
// call that is not causal sees every key.  A row that sees no key is 0
// (the l == 0 guard).  The softmax state (m, l, acc) is fp32.
//
// Replaces the Pallas-TPU kernel src/repro/kernels/flash.py
// (flash_fwd_pallas / _flash_kernel, pallas_call at line 129).  That
// kernel folds the G query heads of a kv head into its rows, walks the
// keys along a sequential grid axis and keeps (m, l, acc) in VMEM
// scratch from one grid step to the next.  Here the walk over the keys
// is a loop inside one block, which owns its rows' state in registers
// from the first key tile to the single write of the output.
//
// Layout: q (B, Sq, H, hd), k (B, Sk, KVH, hd) and v (B, Sk, KVH, hdv),
// each read in place through its strides (the last dimension
// contiguous); out (B, Sq, H, hdv) contiguous, in q's type; lse, when its pointer is not
// null, (B, H, Sq) fp32: each row's log-sum-exp m + log(l) of its
// scaled scores, natural log, +inf for a row that sees no key (the
// backward's exp(s - lse) is then 0).  out is the same bits with and
// without it.  A block owns 64 rows of one
// (b, kv head): row R of that head's Sq * G rows is position R / G,
// head kvh * G + R % G, so every K/V tile the block loads serves all G
// query heads that share it.  Key tiles that lie wholly outside every
// row's mask (the causal future, and before a window) are skipped, and
// tiles that every row sees whole skip the per-score mask test (in a
// causal prefill all but the diagonal tiles).  Ragged Sq, Sk and
// hd < the tile width are masked in the kernel.
//
// What bounds it on an H100: at the LM path's shapes (S = 4,096,
// hd = 128, causal) the tensor cores.  Each (query, visible key) pair
// costs 4 * hd operations, against q, k, v and out read or written
// once: 2 * B * H * hd * S^2 operations for 4 * B * S * (H + KVH) * hd
// bytes, about 800 operations a byte at S = 4,096, far above the
// card's ridge (about 295 in bf16).  So the bf16 path runs both
// products on the tensor cores (mma.sync m16n8k16, bf16 operands, fp32
// accumulation: the q.k products are exact) and rounds p to bf16 for
// P.V, which the stated tolerance accounts for (kernels/ref.py).  K/V
// tiles stream through a two-stage cp.async ring in shared memory
// (zero-filled past Sk and hd), so the next tile's load overlaps this
// tile's products; rows are padded by 8 elements so that ldmatrix is
// free of bank conflicts.
//
// Which shapes it serves: kernels/flash.py routes bf16 at hd = hdv = 64
// and 128 (the GQA configs' head widths, the dense LM path) to
// flash_sm90.cu, the Hopper design with wgmma, TMA and warp
// specialisation.  This file's bf16 kernel serves the other head widths
// (multiples of 8, hd up to 192 and hdv up to 128: the smoke configs'
// hd 16, the probes' hd 8 and 40) and every call of two widths (MLA's
// prefill, hd 192 against hdv 128), and its fp32 kernel every fp32
// call.  Each kernel is a template on the two padded widths (HDK for q
// and k, HDV for v), instantiated at 32/32, 64/64, 128/128 and 192/128;
// a call takes the first pair that holds both of its widths, and the
// tiles are zero-filled past hd and hdv.
//
// The two-width tile: at HDK = 192, HDV = 128 the two stages of K and V
// take 2 * 64 * (200 + 136) * 2 = 86,016 bytes of shared memory, so two
// blocks share an SM (three at 128/128, 69,632 bytes a block), and
// __launch_bounds__(THREADS, 2) leaves a thread 255 registers for the
// q fragments of 12 k-steps (48), the 64-float output accumulator and
// the 32 scores of a tile.
//
// fp32 inputs never touch the tensor cores (no TF32): a second kernel
// does the same walk on the CUDA cores, four threads to a row, each
// owning a quarter of the head dimension.  It is the plain-precision
// path of the probes, not of the LM, which runs in bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // rows ((position, head) pairs) a block
constexpr int BN = 64;          // keys a tile (bf16 kernel)
constexpr int THREADS = 128;    // bf16 kernel: 4 warps of 16 rows
constexpr int BN32 = 32;        // keys a tile (fp32 kernel)
constexpr int THREADS32 = 256;  // fp32 kernel: 4 threads a row
constexpr int HD_MAX = 192;     // widest q and k
constexpr int HDV_MAX = 128;    // widest v

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                // (B, H, Sq) or null
  int64_t q_sb, q_ss, q_sh;  // strides in elements
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int B, Sq, Sk, H, KVH, hd, hdv;   // hd: q and k; hdv: v and out
  int causal, window, q_offset;
  float scale_log2;          // log2(e) / sqrt(hd)
};

// The key tiles [*t0, *t1) that some row of rows [R0, R0 + BM) can see.
__device__ __forceinline__ void key_tiles(const Args& a, int G, int R0,
                                          int bn, int* t0, int* t1) {
  const int rows = a.Sq * G;
  const int R1 = min(R0 + BM, rows) - 1;
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

__device__ __forceinline__ bool visible(const Args& a, int n, int qpos) {
  if (n >= a.Sk) return false;
  if (!a.causal) return true;
  if (n > qpos) return false;
  return a.window <= 0 || n > qpos - a.window;
}

// lse of folded row R (position R / G, head kvh * G + R % G) from its
// running max m2 (log2 units) and denominator l: (m2 + log2 l) ln 2, or
// +inf where l == 0
__device__ __forceinline__ void write_lse(const Args& a, int b, int kvh,
                                          int G, int R, float m2, float l) {
  const int64_t i = ((int64_t)b * a.H + kvh * G + R % G) * a.Sq + R / G;
  a.lse[i] = l == 0.f ? INFINITY : (m2 + log2f(l)) * 0.6931471805599453f;
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

// Rows of BN x HDP bf16 from global (16-byte chunks, zero past
// the valid rows and past hd) into shared rows of LD elements.
template <int HDP>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* base,
                                          int64_t row_stride, int first,
                                          int n_valid, int hd) {
  constexpr int LD = HDP + 8;
  constexpr int CH = HDP / 8;
  for (int i = threadIdx.x; i < BN * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const bool ok = first + r < n_valid && c * 8 < hd;
    const __nv_bfloat16* src =
        ok ? base + (int64_t)(first + r) * row_stride + c * 8 : base;
    cp_async16(dst + r * LD + c * 8, src, ok ? 16 : 0);
  }
}

// HDK: padded width of q and k, HDV: of v; MINB blocks share an SM
// (3: at most 170 registers a thread; 2 at 192/128, where shared memory
// holds no third)
template <int HDK, int HDV, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
    flash_bf16_kernel(const Args a) {
  constexpr int LDK = HDK + 8;       // padded shared rows, elements
  constexpr int LDV = HDV + 8;
  constexpr int TILEK = BN * LDK;    // one K tile
  constexpr int STAGE = TILEK + BN * LDV;   // a K and a V tile
  constexpr int CHK = HDK / 8;
  constexpr int KS = HDK / 16;       // k-steps of q.k
  constexpr int NT = BN / 8;         // 8-key column tiles of S
  constexpr int DT = HDV / 8;        // 8-wide column tiles of out
  static_assert(BM == BN, "the q tile passes through a K tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  // stage s: K at sm + s STAGE, V at sm + s STAGE + TILEK; the q tile
  // passes through stage 1's K before the loop needs it

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int G = a.H / a.KVH;
  const int b = blockIdx.y / a.KVH, kvh = blockIdx.y % a.KVH;
  const int rows = a.Sq * G;
  // the latest rows walk the most key tiles: their blocks go first
  const int R0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(a.k) +
                            (int64_t)b * a.k_sb + (int64_t)kvh * a.k_sh;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(a.v) +
                            (int64_t)b * a.v_sb + (int64_t)kvh * a.v_sh;

  // this thread's two rows of every mma tile: groupID and groupID + 8
  const int r_lo = R0 + warp * 16 + lane / 4;
  const int r_hi = r_lo + 8;
  const int qpos_lo = a.q_offset + r_lo / G;
  const int qpos_hi = a.q_offset + r_hi / G;
  const int cq = 2 * (lane % 4);     // first column of a C fragment

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

  int t0, t1;
  key_tiles(a, G, R0, BN, &t0, &t1);
  // positions of the block's first and last valid rows: a tile that
  // both see whole is seen whole by every row between them
  const int bpos_lo = a.q_offset + R0 / G;
  const int bpos_hi = a.q_offset + (min(R0 + BM, rows) - 1) / G;
  if (t0 < t1) {
    // the q tile, rows R0.. of this (b, kv head), into stage 1's K
    __nv_bfloat16* sq = sm + STAGE;
    for (int i = threadIdx.x; i < BM * CHK; i += THREADS) {
      const int r = i / CHK, c = i % CHK, R = R0 + r;
      const bool ok = R < rows && c * 8 < a.hd;
      const __nv_bfloat16* src =
          ok ? q + (int64_t)b * a.q_sb + (int64_t)(R / G) * a.q_ss +
                   (int64_t)(kvh * G + R % G) * a.q_sh + c * 8
             : q;
      cp_async16(sq + r * LDK + c * 8, src, ok ? 16 : 0);
    }
    load_rows<HDK>(sm, kb, a.k_ss, t0 * BN, a.Sk, a.hd);
    load_rows<HDV>(sm + TILEK, vb, a.v_ss, t0 * BN, a.Sk, a.hdv);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    uint32_t qf[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      ldmatrix_x4(qf[kk], sq + (warp * 16 + lane % 16) * LDK + kk * 16 +
                              (lane / 16) * 8);
    __syncthreads();

    for (int t = t0; t < t1; ++t) {
      const int st = (t - t0) & 1;
      if (t + 1 < t1) {
        __nv_bfloat16* nxt = sm + (st ^ 1) * STAGE;
        load_rows<HDK>(nxt, kb, a.k_ss, (t + 1) * BN, a.Sk, a.hd);
        load_rows<HDV>(nxt + TILEK, vb, a.v_ss, (t + 1) * BN, a.Sk, a.hdv);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const __nv_bfloat16* sk = sm + st * STAGE;
      const __nv_bfloat16* sv = sk + TILEK;

      // S = q k^T for this warp's 16 rows x 64 keys
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t kf[4];
          ldmatrix_x4(kf, sk + (np * 16 + (lane / 16) * 8 + lane % 8) * LDK +
                              kk * 16 + ((lane / 8) % 2) * 8);
          mma_bf16(s[2 * np], qf[kk], kf[0], kf[1]);
          mma_bf16(s[2 * np + 1], qf[kk], kf[2], kf[3]);
        }
      }

      // scale to log2 units, mask (only tiles that some row sees in
      // part), online softmax
      const int n0 = t * BN, n1 = n0 + BN - 1;
      const bool whole = n1 < a.Sk && visible(a, n1, bpos_lo) &&
                         visible(a, n0, bpos_hi);
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= a.scale_log2;
        if (!whole) {
          const int n = n0 + j * 8 + cq;
          if (!visible(a, n, qpos_lo)) s[j][0] = -INFINITY;
          if (!visible(a, n + 1, qpos_lo)) s[j][1] = -INFINITY;
          if (!visible(a, n, qpos_hi)) s[j][2] = -INFINITY;
          if (!visible(a, n + 1, qpos_hi)) s[j][3] = -INFINITY;
        }
        mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
      }
      const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
      // a row that has seen no key yet subtracts 0: exp2(-inf) = 0
      const float base_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
      const float base_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
      const float al_lo = ex2(m_lo - base_lo);
      const float al_hi = ex2(m_hi - base_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][0] = ex2(s[j][0] - base_lo);
        s[j][1] = ex2(s[j][1] - base_lo);
        s[j][2] = ex2(s[j][2] - base_hi);
        s[j][3] = ex2(s[j][3] - base_hi);
        sum_lo += s[j][0] + s[j][1];
        sum_hi += s[j][2] + s[j][3];
      }
      l_lo = l_lo * al_lo + sum_lo;   // this thread's columns only
      l_hi = l_hi * al_hi + sum_hi;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        o[j][0] *= al_lo;
        o[j][1] *= al_lo;
        o[j][2] *= al_hi;
        o[j][3] *= al_hi;
      }

      // out += P v: the C fragments of S are P's A fragments
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int dp = 0; dp < DT / 2; ++dp) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, sv + (kk * 16 + ((lane / 8) % 2) * 8 +
                                      lane % 8) * LDV +
                                    dp * 16 + (lane / 16) * 8);
          mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
          mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
        }
      }
      __syncthreads();   // before the next iteration refills this stage
    }
  }

  // the quad's partial denominators, then one write of each row
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = 1.f / (l_lo == 0.f ? 1.f : l_lo);
  const float inv_hi = 1.f / (l_hi == 0.f ? 1.f : l_hi);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int R = half ? r_hi : r_lo;
    if (R >= rows) continue;
    if (a.lse != nullptr && lane % 4 == 0)
      write_lse(a, b, kvh, G, R, half ? m_hi : m_lo, half ? l_hi : l_lo);
    const float inv = half ? inv_hi : inv_lo;
    const int64_t row_off =
        (((int64_t)b * a.Sq + R / G) * a.H + kvh * G + R % G) * a.hdv;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int d = j * 8 + cq;
      if (d < a.hdv)
        *reinterpret_cast<__nv_bfloat162*>(out + row_off + d) =
            __floats2bfloat162_rn(o[j][2 * half] * inv,
                                  o[j][2 * half + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------
// fp32: CUDA cores, no TF32
// ---------------------------------------------------------------------

// HDK, HDV: the widest q/k and v a call may have
template <int HDK, int HDV>
__global__ void __launch_bounds__(THREADS32)
    flash_f32_kernel(const Args a) {
  __shared__ float sk[BN32][HDK];
  __shared__ float sv[BN32][HDV];
  constexpr int DQ = HDK / 4;        // most q/k dims a thread owns
  constexpr int DV = HDV / 4;        // most v dims a thread owns
  const int G = a.H / a.KVH;
  const int b = blockIdx.y / a.KVH, kvh = blockIdx.y % a.KVH;
  const int rows = a.Sq * G;
  const int R0 = blockIdx.x * BM;
  const int R = R0 + threadIdx.x / 4;   // this thread's row
  const int t4 = threadIdx.x % 4;       // it owns dims t4 + 4 i
  const int nd = a.hd / 4, ndv = a.hdv / 4;
  const int qpos = a.q_offset + R / G;
  const float* q = static_cast<const float*>(a.q);
  const float* kb = static_cast<const float*>(a.k) + (int64_t)b * a.k_sb +
                    (int64_t)kvh * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + (int64_t)b * a.v_sb +
                    (int64_t)kvh * a.v_sh;

  float qr[DQ], acc[DV];
  const float* qrow = q + (int64_t)b * a.q_sb + (int64_t)(R / G) * a.q_ss +
                      (int64_t)(kvh * G + R % G) * a.q_sh;
#pragma unroll
  for (int i = 0; i < DQ; ++i)
    qr[i] = (i < nd && R < rows) ? qrow[t4 + 4 * i] : 0.f;
#pragma unroll
  for (int i = 0; i < DV; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;

  int t0, t1;
  key_tiles(a, G, R0, BN32, &t0, &t1);
  for (int t = t0; t < t1; ++t) {
    for (int i = threadIdx.x; i < BN32 * a.hd; i += THREADS32) {
      const int r = i / a.hd, d = i % a.hd, n = t * BN32 + r;
      sk[r][d] = n < a.Sk ? kb[(int64_t)n * a.k_ss + d] : 0.f;
    }
    for (int i = threadIdx.x; i < BN32 * a.hdv; i += THREADS32) {
      const int r = i / a.hdv, d = i % a.hdv, n = t * BN32 + r;
      sv[r][d] = n < a.Sk ? vb[(int64_t)n * a.v_ss + d] : 0.f;
    }
    __syncthreads();
    float sc[BN32];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BN32; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DQ; ++i)
        if (i < nd) part = fmaf(qr[i], sk[j][t4 + 4 * i], part);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      sc[j] = visible(a, t * BN32 + j, qpos) ? part * a.scale_log2
                                             : -INFINITY;
      mx = fmaxf(mx, sc[j]);
    }
    const float mn = fmaxf(m, mx);
    const float base = mn == -INFINITY ? 0.f : mn;
    const float alpha = exp2f(m - base);
    m = mn;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BN32; ++j) {
      sc[j] = exp2f(sc[j] - base);
      sum += sc[j];
    }
    l = l * alpha + sum;
#pragma unroll
    for (int i = 0; i < DV; ++i) {
      if (i < ndv) {
        float x = acc[i] * alpha;
#pragma unroll
        for (int j = 0; j < BN32; ++j) x = fmaf(sc[j], sv[j][t4 + 4 * i], x);
        acc[i] = x;
      }
    }
    __syncthreads();
  }
  if (R < rows) {
    if (a.lse != nullptr && t4 == 0) write_lse(a, b, kvh, G, R, m, l);
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    float* out = static_cast<float*>(a.o) +
                 (((int64_t)b * a.Sq + R / G) * a.H + kvh * G + R % G) * a.hdv;
#pragma unroll
    for (int i = 0; i < DV; ++i)
      if (i < ndv) out[t4 + 4 * i] = acc[i] * inv;
  }
}

template <int HDK, int HDV, int MINB>
cudaError_t launch_bf16(const Args& a, dim3 grid, cudaStream_t st) {
  // 2 stages of a K and a V tile
  constexpr int bytes = 2 * BN * (HDK + 8 + HDV + 8) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<HDK, HDV, MINB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  flash_bf16_kernel<HDK, HDV, MINB><<<grid, THREADS, bytes, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: device pointers; strides in elements (the last
// dimension contiguous); hd: the width of q and k, hdv: of v and out;
// lse: the address of a (B, H, Sq) fp32 buffer, passed as an integer
// like the sizes, or 0 for none; is_bf16 picks the tensor-core kernel,
// else fp32.
// The caller has checked shapes, hd % 8 == hdv % 8 == 0, hd <= 192,
// hdv <= 128, the 16-byte alignment of bf16 rows, and 0 <= q_offset,
// 0 <= window.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, int64_t q_sb, int64_t q_ss,
                         int64_t q_sh, int64_t k_sb, int64_t k_ss,
                         int64_t k_sh, int64_t v_sb, int64_t v_ss,
                         int64_t v_sh, int64_t B, int64_t Sq, int64_t Sk,
                         int64_t H, int64_t KVH, int64_t hd, int64_t hdv,
                         int64_t causal, int64_t window, int64_t q_offset,
                         int64_t lse, int64_t is_bf16, void* stream) {
  if (B <= 0 || Sq <= 0) return (int)cudaGetLastError();
  if (hd > HD_MAX || hdv > HDV_MAX) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = out;
  a.lse = reinterpret_cast<float*>(lse);
  a.q_sb = q_sb;
  a.q_ss = q_ss;
  a.q_sh = q_sh;
  a.k_sb = k_sb;
  a.k_ss = k_ss;
  a.k_sh = k_sh;
  a.v_sb = v_sb;
  a.v_ss = v_ss;
  a.v_sh = v_sh;
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
  a.scale_log2 = (float)(1.4426950408889634 / sqrt((double)hd));
  const int64_t rows = Sq * (H / KVH);
  dim3 grid((unsigned)((rows + BM - 1) / BM), (unsigned)(B * KVH));
  cudaStream_t st = (cudaStream_t)stream;
  if (!is_bf16) {
    if (hd <= 128)
      flash_f32_kernel<128, 128><<<grid, THREADS32, 0, st>>>(a);
    else
      flash_f32_kernel<HD_MAX, HDV_MAX><<<grid, THREADS32, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  // the first pair of padded widths that holds both
  if (hd <= 32 && hdv <= 32) return (int)launch_bf16<32, 32, 3>(a, grid, st);
  if (hd <= 64 && hdv <= 64) return (int)launch_bf16<64, 64, 3>(a, grid, st);
  if (hd <= 128) return (int)launch_bf16<128, 128, 3>(a, grid, st);
  return (int)launch_bf16<HD_MAX, HDV_MAX, 2>(a, grid, st);
}
