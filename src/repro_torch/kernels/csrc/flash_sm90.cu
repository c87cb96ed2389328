// Flash-attention forward, GQA, bf16, for Hopper (sm_90a): wgmma, TMA
// and warp specialisation.  Head widths (q/k, v): 64/64, 128/128 (every
// GQA config) and 192/128 (MLA's prefill: q and k carry 128 "nope" and
// 64 RoPE columns, v 128).
//
// For every batch b, query position s and head h (kv head h / G):
//   out[b, s, h] = sum_n p[n] v[b, n, h / G] / sum_n p[n],
//   p[n] = exp(q[b, s, h] . k[b, n, h / G] / sqrt(hd) - max)
// with hd q and k's width (not v's), over the keys n the mask lets
// through: with qpos = q_offset + s, a causal call sees n <= qpos and,
// with a window, n > qpos - window; a call that is not causal sees every
// key.  A row that sees no key is 0 (the l == 0 guard).  The softmax
// state (m, l, acc) is fp32 and the output bf16: the function of flash.cu
// and of ref.attention_ref.
//
// Replaces the Pallas-TPU kernel src/repro/kernels/flash.py
// (flash_fwd_pallas / _flash_kernel, pallas_call at line 129) for bf16
// at those three pairs of widths; fp32 and the other bf16 widths stay on
// flash.cu.
//
// What bounds it on an H100: the tensor cores.  At the LM path's shape
// (B = 4, S = 4,096, 32/8 heads of 128, causal) a call does 550 GFLOP
// (the visible half of the causal products) on 335 MB, about 1,600
// operations a byte, far above the card's ridge of about 295 in bf16;
// at MLA's (16 heads, 192/128) 344 GFLOP on 235 MB.
// Beside the products, every 64 x 128 tile of scores costs each of its
// threads 64 exponentials on the special-function unit (16 a cycle on
// an SM against 4,096 tensor-core operations) and a row max, sums and
// a rescale; measured, the products run under that softmax path, which
// is what the kernel's time follows.  So every design element serves to
// keep the tensor cores fed and the softmax off their critical path:
//
// * wgmma.  S = Q K^T is wgmma.mma_async m64n128k16 with both operands
//   in shared memory, hd / 16 steps over hd / 64 swizzled 64-wide
//   chunks; O += P V is m64n{hdv}k16 with P taken from registers (S's
//   fp32 accumulator fragment rounded to bf16 is the A-operand fragment
//   as it stands) and V as the MN-major B operand (transpose bit set;
//   at hdv 128 its two 64-wide chunks lie one leading-byte offset
//   apart).  One warpgroup issues a 64 x 128 product from one copy of
//   the K tile in shared memory, where mma.sync had every warp ldmatrix
//   it again.  At 192/128 a consumer holds what it holds at 128/128 (S
//   and O 64 x 128 fp32, P 32 registers): only S's product is longer.
// * Warp specialisation.  A block is 384 threads: a producer
//   warpgroup, which gives up registers (setmaxnreg.dec 24) and whose
//   one thread keeps TMA loads in flight, and two consumer warpgroups
//   (setmaxnreg.inc 240), which hold the S and O accumulators (64 + 64
//   fp32 registers a thread at hdv 128) without spilling.
// * TMA.  K and V tiles of 128 keys (B, Sk, KVH, hd or hdv read through
//   their strides as a 4-d tensor map, 128-byte swizzle, zero-filled
//   past Sk) stream through a two-stage ring; a full barrier per tile
//   counts the bytes in, an empty barrier counts the consumer warps out.
//   At 192/128 q, the ring and the barriers take 214,080 bytes of
//   shared memory.
// * Rows.  Each consumer warpgroup owns 64 folded (position, head)
//   rows, a block 128: row R of a kv head's Sq * G rows is position
//   R / G, head kvh * G + R % G, so each K/V tile serves all G query
//   heads.  Q is loaded once by the consumers' own 16-byte loads and
//   written in the same swizzled layout (a row's heads are not one
//   box of a tensor map unless G divides the tile).
// * Ping-pong.  The two consumer warpgroups take turns at the tensor
//   cores through two named barriers: in its turn a warpgroup issues
//   this tile's S = Q K^T and the previous tile's O += P V, then hands
//   the turn over and runs its softmax (exp, max, sums, rescale) while
//   the other warpgroup's products run.
// * Masking.  Key tiles outside every row's mask (the causal future,
//   before a window) are never loaded; tiles that all of a
//   warpgroup's rows see whole skip the per-score test.  Blocks are
//   launched by (batch, kv head), so that the blocks at work share one
//   K/V set in L2, and within each the latest rows, which walk the most
//   tiles, first.
// * Exponent.  ex2.approx with 1/sqrt(hd) folded into log2(e), one FMA
//   a score.
//
// Layout: q (B, Sq, H, hd), k (B, Sk, KVH, hd) and v (B, Sk, KVH, hdv),
// read in place through their strides (last dimension contiguous, rows
// and strides 16-byte aligned, as TMA needs: MLA's v, a view into a
// wider product, is read where it lies); out (B, Sq, H, hdv) contiguous
// bf16; lse, when its pointer is not null, (B, H, Sq) fp32: each row's
// log-sum-exp m + log(l) of its scaled scores, natural log, +inf for a
// row that sees no key (the backward's exp(s - lse) is then 0).  out is
// the same bits with and without it.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WG_ROWS = 64;     // rows a consumer warpgroup
constexpr int BM = 128;         // rows a block
constexpr int BN = 128;         // keys a tile
constexpr int STAGES = 2;       // K/V ring depth
constexpr int THREADS = 384;    // producer + two consumer warpgroups
constexpr int LINE = 128;       // bytes of a swizzled shared line (64 bf16)

struct Args {
  const __nv_bfloat16* q;
  __nv_bfloat16* o;
  float* lse;                   // (B, H, Sq) or null
  int64_t q_sb, q_ss, q_sh;     // strides in elements
  int B, Sq, Sk, H, KVH;
  int causal, window, q_offset;
  float scale_log2;             // log2(e) / sqrt(hd)
};

template <int HDK, int HDV>
struct Layout {
  static constexpr int CHUNKS_K = HDK / 64;           // 64-wide column chunks
  static constexpr int CHUNKS_V = HDV / 64;
  static constexpr int Q_WG = WG_ROWS * HDK * 2;      // one warpgroup's q
  static constexpr int TILE_K = BN * HDK * 2;         // one K tile
  static constexpr int TILE_V = BN * HDV * 2;         // one V tile
  static constexpr int STAGE = TILE_K + TILE_V;       // a stage: K, then V
  static constexpr int KV = 2 * Q_WG;                 // ring after q
  static constexpr int BAR = KV + STAGES * STAGE;     // mbarriers last
  static constexpr int SMEM = BAR + 4 * STAGES * 8 + 1024;  // + alignment
  static_assert(HDK % 64 == 0 && (HDV == 64 || HDV == 128),
                "q/k in 64-wide chunks; P V is m64n64 or m64n128");
  static_assert(SMEM <= 232448, "more shared memory than a block may use");
};

// The key tiles [*t0, *t1) that some row of rows [R0, R0 + BM) can see.
__device__ __forceinline__ void key_tiles(const Args& a, int G, int R0,
                                          int* t0, int* t1) {
  const int rows = a.Sq * G;
  const int R1 = min(R0 + BM, rows) - 1;
  int k0 = 0, k1 = a.Sk;
  if (a.causal) {
    const int pos_lo = a.q_offset + R0 / G;
    const int pos_hi = a.q_offset + R1 / G;
    k1 = max(0, min(a.Sk, pos_hi + 1));
    if (a.window > 0) k0 = max(0, pos_lo - a.window + 1);
  }
  *t0 = k0 / BN;
  *t1 = k1 > k0 ? (k1 + BN - 1) / BN : *t0;
}

__device__ __forceinline__ bool visible(const Args& a, int n, int qpos) {
  if (n >= a.Sk) return false;
  if (!a.causal) return true;
  if (n > qpos) return false;
  return a.window <= 0 || n > qpos - a.window;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA, named barriers ---------------------------------------------

// one box (64 hd x 1 head x BN keys x 1 batch) of a 4-d tensor map
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int h, int n,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(h),
      "r"(n), "r"(b)
      : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- wgmma -------------------------------------------------------------

// shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of wgmma's registers across
// the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (64 x 128 fp32) (+)= A (64 x 16, smem, K-major) B^T (128 x 16, smem,
// K-major); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64 fp32) += A (64 x 16 bf16, registers) B (16 x 64, smem,
// MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float* d,
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 fp32) += A (64 x 16 bf16, registers) B (16 x 128, smem,
// MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float* d,
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
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

// ---- the kernel ------------------------------------------------------

template <int HDK, int HDV>
__global__ void __launch_bounds__(THREADS, 1)
    flash_sm90_kernel(const __grid_constant__ CUtensorMap tmk,
                      const __grid_constant__ CUtensorMap tmv,
                      const Args a) {
  using L = Layout<HDK, HDV>;
  extern __shared__ unsigned char smem_raw[];
  // swizzle atoms (8 lines of 128 bytes) start on 1024-byte boundaries
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);
  // full_k[s], full_v[s], empty_k[s], empty_v[s]
  const uint32_t bars = base + L::BAR;
#define FULL_K(s) (bars + 8 * (s))
#define FULL_V(s) (bars + 8 * (STAGES + (s)))
#define EMPTY_K(s) (bars + 8 * (2 * STAGES + (s)))
#define EMPTY_V(s) (bars + 8 * (3 * STAGES + (s)))

  const int G = a.H / a.KVH;
  const int rows = a.Sq * G;
  const int n_rb = (rows + BM - 1) / BM;
  // blocks by (batch, kv head), so that the blocks at work share one
  // K/V set in L2; within each the latest rows, which walk the most key
  // tiles, first
  const int rb = n_rb - 1 - (int)(blockIdx.x % n_rb);
  const int bh = (int)(blockIdx.x / n_rb);
  const int b = bh / a.KVH, kvh = bh % a.KVH;
  const int R0 = rb * BM;
  int t0, t1;
  key_tiles(a, G, R0, &t0, &t1);
  const int n = t1 - t0;   // both consumers walk all of them

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(FULL_K(s), 1);
      mbar_init(FULL_V(s), 1);
      mbar_init(EMPTY_K(s), 8);   // one arrival a consumer warp
      mbar_init(EMPTY_V(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the ring full --------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      for (int j = 0; j < n; ++j) {
        const int s = j % STAGES;
        const uint32_t ph = ((j / STAGES) & 1) ^ 1;   // first round free
        const int key = (t0 + j) * BN;
        const uint32_t ks = base + L::KV + s * L::STAGE;
        mbar_wait(EMPTY_K(s), ph);
        mbar_expect_tx(FULL_K(s), L::TILE_K);
#pragma unroll
        for (int c = 0; c < L::CHUNKS_K; ++c)
          tma_load(ks + c * BN * LINE, &tmk, FULL_K(s), c * 64, kvh, key, b);
        mbar_wait(EMPTY_V(s), ph);
        mbar_expect_tx(FULL_V(s), L::TILE_V);
#pragma unroll
        for (int c = 0; c < L::CHUNKS_V; ++c)
          tma_load(ks + L::TILE_K + c * BN * LINE, &tmv, FULL_V(s), c * 64,
                   kvh, key, b);
      }
    }
  } else {
    // ---- consumers: 64 rows each ---------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int Rw = R0 + cw * WG_ROWS;
    const uint32_t qs = base + cw * L::Q_WG;
    // this thread's two rows of every accumulator: g and g + 8
    const int r_lo = Rw + warp * 16 + lane / 4, r_hi = r_lo + 8;
    const int qpos_lo = a.q_offset + r_lo / G;
    const int qpos_hi = a.q_offset + r_hi / G;
    // a tile that the warpgroup's first and last valid rows see whole
    // is seen whole by every row between them
    const int wpos_lo = a.q_offset + Rw / G;
    const int wpos_hi = a.q_offset + max(Rw, min(Rw + WG_ROWS, rows) - 1) / G;
    const int cq = 2 * (lane % 4);   // first column of a fragment

    float o[L::CHUNKS_V * 32];
#pragma unroll
    for (int i = 0; i < L::CHUNKS_V * 32; ++i) o[i] = 0.f;
    float sacc[64];
    uint32_t p[BN / 16][4];
    float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

    if (n > 0) {
      // the first turn at the tensor cores is consumer 0's
      if (cw == 1) bar_arrive(1, 256);
      // q rows Rw.. into shared memory, swizzled as TMA writes a tile:
      // 16-byte piece j of line r at (j ^ r % 8)
      constexpr int CH = HDK / 8;
      // all loads in flight before the first store
      constexpr int PER = WG_ROWS * CH / 128;   // 16-byte pieces a thread
      uint4 qv[PER];
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int i = tid + u * 128, r = i / CH, c = i % CH, R = Rw + r;
        qv[u] = make_uint4(0u, 0u, 0u, 0u);
        if (R < rows)
          qv[u] = *reinterpret_cast<const uint4*>(
              a.q + (int64_t)b * a.q_sb + (int64_t)(R / G) * a.q_ss +
              (int64_t)(kvh * G + R % G) * a.q_sh + c * 8);
      }
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int i = tid + u * 128, r = i / CH, c = i % CH;
        *reinterpret_cast<uint4*>(sbase + cw * L::Q_WG +
                                  (c / 8) * WG_ROWS * LINE + r * LINE +
                                  ((c % 8) ^ (r % 8)) * 16) = qv[u];
      }
      // generic-proxy stores made visible to wgmma's async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(3 + cw, 128);

      float al_lo = 0.f, al_hi = 0.f;   // o's rescale before the next P V
      // S = Q K^T of tile j, issued and committed
      auto issue_s = [&](int j) {
        const uint32_t ks = base + L::KV + (j % STAGES) * L::STAGE;
        mbar_wait(FULL_K(j % STAGES), (j / STAGES) & 1);
        fence_regs(sacc);
        wg_fence();
        // 16 columns a step, four steps a 64-wide chunk of q and of K
#pragma unroll
        for (int kk = 0; kk < HDK / 16; ++kk)
          wgmma_ss_n128(
              sacc,
              desc_sw128(qs + (kk / 4) * WG_ROWS * LINE + (kk % 4) * 32, 16,
                         1024),
              desc_sw128(ks + (kk / 4) * BN * LINE + (kk % 4) * 32, 16,
                         1024),
              kk > 0);
        wg_commit();
      };
      // o = o * alpha + P V of tile j, issued and committed
      auto issue_pv = [&](int j) {
        const uint32_t vs = base + L::KV + (j % STAGES) * L::STAGE + L::TILE_K;
#pragma unroll
        for (int i = 0; i < L::CHUNKS_V * 32; i += 4) {
          o[i] *= al_lo;
          o[i + 1] *= al_lo;
          o[i + 2] *= al_hi;
          o[i + 3] *= al_hi;
        }
        mbar_wait(FULL_V(j % STAGES), (j / STAGES) & 1);
        fence_regs(o);
        fence_regs(p);
        wg_fence();
        if constexpr (HDV == 128) {
          // one m64n128k16 a 16 keys: V's two 64-wide chunks lie LBO
          // apart along N, its 8-key groups SBO apart along K
#pragma unroll
          for (int kk = 0; kk < BN / 16; ++kk)
            wgmma_rs_n128(o, p[kk],
                          desc_sw128(vs + kk * 16 * LINE, BN * LINE, 1024));
        } else {
#pragma unroll
          for (int kk = 0; kk < BN / 16; ++kk)
            wgmma_rs_n64(o, p[kk],
                         desc_sw128(vs + kk * 16 * LINE, 1024, 1024));
        }
        wg_commit();
      };
      // mask (only tiles that some row sees in part) and online softmax
      // of tile j in log2 units; S becomes P, in fp32 and in p as bf16
      auto softmax = [&](int j) {
        const int n0 = (t0 + j) * BN;
        const bool whole = n0 + BN - 1 < a.Sk &&
                           visible(a, n0 + BN - 1, wpos_lo) &&
                           visible(a, n0, wpos_hi);
        if (!whole) {
#pragma unroll
          for (int jj = 0; jj < BN / 8; ++jj) {
            const int nk = n0 + jj * 8 + cq;
            if (!visible(a, nk, qpos_lo)) sacc[4 * jj] = -INFINITY;
            if (!visible(a, nk + 1, qpos_lo)) sacc[4 * jj + 1] = -INFINITY;
            if (!visible(a, nk, qpos_hi)) sacc[4 * jj + 2] = -INFINITY;
            if (!visible(a, nk + 1, qpos_hi)) sacc[4 * jj + 3] = -INFINITY;
          }
        }
        // four partial maxima a row keep the dependency chain short (a
        // mask test inside this loop kept ptxas from scheduling across
        // its 8-key steps: 17% of the call)
        float pm_lo[4], pm_hi[4];
#pragma unroll
        for (int jj = 0; jj < BN / 8; ++jj) {
          const float lo = fmaxf(sacc[4 * jj], sacc[4 * jj + 1]);
          const float hi = fmaxf(sacc[4 * jj + 2], sacc[4 * jj + 3]);
          pm_lo[jj % 4] = jj < 4 ? lo : fmaxf(pm_lo[jj % 4], lo);
          pm_hi[jj % 4] = jj < 4 ? hi : fmaxf(pm_hi[jj % 4], hi);
        }
        float mx_lo =
            fmaxf(fmaxf(pm_lo[0], pm_lo[1]), fmaxf(pm_lo[2], pm_lo[3]));
        float mx_hi =
            fmaxf(fmaxf(pm_hi[0], pm_hi[1]), fmaxf(pm_hi[2], pm_hi[3]));
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
          mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
        }
        const float mn_lo = fmaxf(m_lo, mx_lo * a.scale_log2);
        const float mn_hi = fmaxf(m_hi, mx_hi * a.scale_log2);
        // a row that has seen no key yet subtracts 0: exp2(-inf) = 0
        const float base_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
        const float base_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
        al_lo = ex2(m_lo - base_lo);
        al_hi = ex2(m_hi - base_hi);
        m_lo = mn_lo;
        m_hi = mn_hi;
        float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
        for (int jj = 0; jj < BN / 8; ++jj) {
          sacc[4 * jj] = ex2(fmaf(sacc[4 * jj], a.scale_log2, -base_lo));
          sacc[4 * jj + 1] =
              ex2(fmaf(sacc[4 * jj + 1], a.scale_log2, -base_lo));
          sacc[4 * jj + 2] =
              ex2(fmaf(sacc[4 * jj + 2], a.scale_log2, -base_hi));
          sacc[4 * jj + 3] =
              ex2(fmaf(sacc[4 * jj + 3], a.scale_log2, -base_hi));
          sum_lo += sacc[4 * jj] + sacc[4 * jj + 1];
          sum_hi += sacc[4 * jj + 2] + sacc[4 * jj + 3];
        }
        l_lo = l_lo * al_lo + sum_lo;   // this thread's columns only
        l_hi = l_hi * al_hi + sum_hi;
      };
      // S's accumulator fragment is P's A fragment, rounded to bf16
      auto pack_p = [&]() {
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          p[kk][0] = pack_bf16(sacc[8 * kk], sacc[8 * kk + 1]);
          p[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
          p[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
          p[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
        }
      };

      // tile 0: S alone.  Each turn at the tensor cores ends by handing
      // it to the other warpgroup, but consumer 1's last: consumer 0
      // takes no turn after it.
      bar_sync(1 + cw, 256);
      issue_s(0);
      if (!(cw == 1 && n == 1)) bar_arrive(2 - cw, 256);
      wg_wait<0>();
      fence_regs(sacc);
      if (lane == 0) mbar_arrive(EMPTY_K(0));
      softmax(0);
      pack_p();
      // tile j: in this warpgroup's turn, S of tile j and P V of tile
      // j - 1; then tile j's softmax while the other warpgroup's
      // products run
      for (int j = 1; j < n; ++j) {
        bar_sync(1 + cw, 256);
        issue_s(j);
        issue_pv(j - 1);
        if (!(cw == 1 && j == n - 1)) bar_arrive(2 - cw, 256);
        wg_wait<1>();   // S of tile j
        fence_regs(sacc);
        if (lane == 0) mbar_arrive(EMPTY_K(j % STAGES));
        softmax(j);
        wg_wait<0>();   // P V of tile j - 1
        fence_regs(o);
        fence_regs(p);
        if (lane == 0) mbar_arrive(EMPTY_V((j - 1) % STAGES));
        pack_p();
      }
      issue_pv(n - 1);   // the last tile's P V
      wg_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(EMPTY_V((n - 1) % STAGES));
    }

    // the quad's partial denominators, then one write of each row
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
    const float inv_lo = 1.f / (l_lo == 0.f ? 1.f : l_lo);
    const float inv_hi = 1.f / (l_hi == 0.f ? 1.f : l_hi);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int R = half ? r_hi : r_lo;
      if (R >= rows) continue;
      if (a.lse != nullptr && lane % 4 == 0) {
        // (m2 + log2 l) ln 2 from the log2-unit max m2, +inf where l == 0
        const float m2 = half ? m_hi : m_lo, l = half ? l_hi : l_lo;
        a.lse[((int64_t)b * a.H + kvh * G + R % G) * a.Sq + R / G] =
            l == 0.f ? INFINITY : (m2 + log2f(l)) * 0.6931471805599453f;
      }
      const float inv = half ? inv_hi : inv_lo;
      __nv_bfloat16* out =
          a.o + (((int64_t)b * a.Sq + R / G) * a.H + kvh * G + R % G) * HDV;
#pragma unroll
      for (int c = 0; c < L::CHUNKS_V; ++c)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          *reinterpret_cast<__nv_bfloat162*>(out + c * 64 + i * 8 + cq) =
              __floats2bfloat162_rn(o[c * 32 + 4 * i + 2 * half] * inv,
                                    o[c * 32 + 4 * i + 2 * half + 1] * inv);
    }
  }
#undef FULL_K
#undef FULL_V
#undef EMPTY_K
#undef EMPTY_V
}

// every lse of a call with no key: +inf
__global__ void fill_inf(float* x, int64_t n) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    x[i] = INFINITY;
}

// ---- host ------------------------------------------------------------

// cuTensorMapEncodeTiled, a driver-API function, reached through the
// runtime so that the library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// K or V (B, Sk, KVH, hd) as a 4-d map: dims (hd, KVH, Sk, B), byte
// strides (sh, ss, sb); boxes of 64 x 1 x BN x 1, 128-byte swizzle,
// zeros past Sk.  A dimension of size 1 never moves the address, so its
// stride is given as the packed one.
CUresult make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr,
                  int64_t sb, int64_t ss, int64_t sh, int64_t B, int64_t Sk,
                  int64_t KVH, int64_t hd) {
  int64_t st[3] = {sh * 2, ss * 2, sb * 2};
  if (KVH == 1) st[0] = hd * 2;
  if (Sk == 1) st[1] = st[0] * KVH;
  if (B == 1) st[2] = st[1] * Sk;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)KVH,
                              (cuuint64_t)Sk, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[0], (cuuint64_t)st[1],
                                 (cuuint64_t)st[2]};
  const cuuint32_t box[4] = {64, 1, BN, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int HDK, int HDV>
cudaError_t launch(const CUtensorMap& mk, const CUtensorMap& mv,
                   const Args& a, unsigned blocks, cudaStream_t st) {
  constexpr int bytes = Layout<HDK, HDV>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_sm90_kernel<HDK, HDV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  flash_sm90_kernel<HDK, HDV><<<blocks, THREADS, bytes, st>>>(mk, mv, a);
  return cudaGetLastError();
}

}  // namespace

// Error codes besides cudaError_t: 1000 + the CUresult of a tensor map
// that did not encode, 999 when the driver has no cuTensorMapEncodeTiled.
// q, k, v, out: device pointers; strides in elements (the last
// dimension contiguous); hd, hdv: the widths of q/k and of v, one of
// the instantiated pairs 64/64, 128/128 and 192/128 (flash.cu's entry
// takes the same arguments and other widths); lse: the address of a
// (B, H, Sq) fp32 buffer, passed as an integer like the sizes, or 0 for
// none.  The caller has checked shapes, bf16, the 16-byte alignment of
// pointers and strides, and 0 <= q_offset, 0 <= window.
extern "C" int flash_sm90_fwd(const void* q, const void* k, const void* v,
                              void* out, int64_t q_sb, int64_t q_ss,
                              int64_t q_sh, int64_t k_sb, int64_t k_ss,
                              int64_t k_sh, int64_t v_sb, int64_t v_ss,
                              int64_t v_sh, int64_t B, int64_t Sq,
                              int64_t Sk, int64_t H, int64_t KVH, int64_t hd,
                              int64_t hdv, int64_t causal, int64_t window,
                              int64_t q_offset, int64_t lse, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || Sq <= 0) return (int)cudaGetLastError();
  // the instantiated (hd, hdv) pairs; other widths go to flash.cu
  if (!((hd == 64 && hdv == 64) || (hd == 128 && hdv == 128) ||
        (hd == 192 && hdv == 128)))
    return (int)cudaErrorInvalidValue;
  if (Sk <= 0) {  // no key: every row is 0, every lse +inf
    cudaError_t err =
        cudaMemsetAsync(out, 0, (size_t)(B * Sq * H * hdv * 2), st);
    if (err != cudaSuccess || lse == 0) return (int)err;
    fill_inf<<<256, 256, 0, st>>>(reinterpret_cast<float*>(lse),
                                  B * H * Sq);
    return (int)cudaGetLastError();
  }
  const int64_t blocks = (Sq * (H / KVH) + BM - 1) / BM * B * KVH;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  EncodeTiled enc = encoder();
  if (enc == nullptr) return 999;
  CUtensorMap mk, mv;
  CUresult r = make_map(enc, &mk, k, k_sb, k_ss, k_sh, B, Sk, KVH, hd);
  if (r == CUDA_SUCCESS)
    r = make_map(enc, &mv, v, v_sb, v_ss, v_sh, B, Sk, KVH, hdv);
  if (r != CUDA_SUCCESS) return 1000 + (int)r;
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.o = static_cast<__nv_bfloat16*>(out);
  a.lse = reinterpret_cast<float*>(lse);
  a.q_sb = q_sb;
  a.q_ss = q_ss;
  a.q_sh = q_sh;
  a.B = (int)B;
  a.Sq = (int)Sq;
  a.Sk = (int)Sk;
  a.H = (int)H;
  a.KVH = (int)KVH;
  a.causal = (int)causal;
  a.window = (int)window;
  a.q_offset = (int)q_offset;
  // the scale is q and k's width's, whatever v's
  a.scale_log2 = (float)(1.4426950408889634 / sqrt((double)hd));
  if (hd == 64) return (int)launch<64, 64>(mk, mv, a, (unsigned)blocks, st);
  if (hd == 128)
    return (int)launch<128, 128>(mk, mv, a, (unsigned)blocks, st);
  return (int)launch<192, 128>(mk, mv, a, (unsigned)blocks, st);
}
