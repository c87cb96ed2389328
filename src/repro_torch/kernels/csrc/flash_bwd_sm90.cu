// Flash-attention backward, GQA, bf16, for Hopper (sm_90a): wgmma, TMA
// and warp specialisation.  A template on the widths of q/k (HDK) and of
// v (HDV), instantiated at 64/64 and 128/128 (the head widths of every
// GQA config) and 192/128 (MLA's prefill: q/k nope + rope against
// v_head_dim, DeepSeek-V2-Lite's 128 + 64 and 128).
//
// The function of flash_bwd.cu (and of ref.attention_bwd_ref): from q
// (B, Sq, H, hd), k (B, Sk, KVH, hd), v (B, Sk, KVH, hdv), the forward's
// output out (B, Sq, H, hdv), its row log-sum-exp lse (B, H, Sq; natural
// log, +inf for a row that sees no key) and dout = dL/dout, for every
// batch b and head h (kv head h / G):
//   P[s, n]  = exp(q_s . k_n / sqrt(hd) - lse_s)   (0 where masked)
//   D[s]     = sum_d dout[s, d] out[s, d]          (fp32, over hdv)
//   dS[s, n] = P[s, n] (dout_s . v_n - D[s]) / sqrt(hd)
//   dq_s = sum_n dS[s, n] k_n
//   dk_n = sum over the G heads and s of dS[s, n] q_s
//   dv_n = sum over the G heads and s of P[s, n] dout_s
// with the forward's masks: query position qpos = q_offset + s; a causal
// call sees n <= qpos and, with a window, n > qpos - window.  P and dS
// are rounded to bf16 for the products that take them, every product
// sums in fp32, and dq, dk and dv are written once each, in bf16.
//
// Replaces no Pallas kernel: the reference has no Pallas backward.  It
// is the counterpart of the jnp custom_vjp
// src/repro/models/layers.py::_flash_vjp_bwd (line 245), which takes a
// v narrower than q and k as it comes, for bf16 at the three pairs
// above; fp32 and the other bf16 widths stay on flash_bwd.cu.
//
// What bounds it on an H100: the tensor cores.  Each (query, visible
// key) pair and head needs five products (S, dP, dV, dK, dQ): S, dK and
// dQ of 2 hd operations, dP and dV of 2 hdv, against nine arrays of
// B S H hd or hdv read or written once: about 2,000 operations a byte
// at the training path's shape, far above the card's ridge of about 295
// in bf16.  Beside the products, every score costs an exponential on
// the special-function unit in each of the two kernels below and a
// handful of FMAs.  So the design keeps the tensor cores fed from
// shared memory written by TMA and runs the exponentials of one
// warpgroup under the other's products:
//
// * Determinism.  No floating-point atomics: dq, dk and dv are each
//   summed by one thread in one fixed order, so two calls give the same
//   bits.  The price is that S and dP are computed in both kernels:
//   seven products where five would do, a floor of 7/5 of the bound.
// * wgmma.  Every product is wgmma.mma_async.  S and dP are SS products
//   (both operands in shared memory, K-major, 12 k16 steps over three
//   swizzled 64-wide chunks at hd 192); P and dS are formed in
//   registers from the fp32 accumulator fragment, which rounded to bf16
//   is the A fragment of the next product as it stands; dV, dK and dQ
//   are RS products whose B operand (dout, q, k) is MN-major (the
//   transpose bit; its 64-wide chunks lie one leading-byte offset apart,
//   and at 192 an n128 product over the first two chunks and an n64
//   over the third make the m64n192 accumulator).  One warpgroup issues
//   a 64-row product from one copy of its operands, where mma.sync had
//   every warp ldmatrix them again.
// * Warp specialisation.  A block is 384 threads: a producer warpgroup,
//   which gives up registers (setmaxnreg.dec 24) and whose one thread
//   keeps TMA loads in flight, and two consumer warpgroups
//   (setmaxnreg.inc 240).  Tiles arrive through a three-stage ring of
//   full/empty mbarriers: a tile is read by two turns of its consumer
//   (S, dP in one, the RS product in the next), so two stages would
//   leave the producer one tile behind.
// * Ping-pong.  The two consumer warpgroups take turns at the tensor
//   cores through two named barriers, and each forms its P and dS
//   (exponentials, masks) while the other's products run.  In its turn
//   a dQ warpgroup issues this tile's S and dP and the previous tile's
//   dQ product; a dK/dV warpgroup first lets the previous tile's dV and
//   dK products drain, then issues this tile's S^T and dP^T (below).
// * Heads one after another, not folded rows.  A tile of rows is
//   positions of one query head: one TMA box of (B, Sq, H, hd), a mask
//   that is one compare a score with no division by G, and row
//   statistics that are contiguous floats.
// * Registers.  ptxas gives the consumers the 240 of setmaxnreg, but
//   when the values live across a wgmma's flight do not fit, it
//   serialises every wgmma (C7512) or spills.  A dK/dV warpgroup holds
//   dK and dV (HDK / 2 + HDV / 2 fp32 a thread: 64 + 64 at 128/128);
//   S^T and dP^T of a BR-position tile take BR more and their bf16
//   copies BR / 2.  Draining the dV/dK products before S^T and dP^T are
//   issued, and issuing the first product of each chain as an overwrite
//   ("=f", so the old S^T is dead), keeps the copies and the new S^T
//   apart: 64-position tiles at 128/128 and 128-position tiles at 64/64
//   fit, where issuing both in one flight fitted 32 and 64 positions
//   and ran slower (measured: 2.42 against 1.86 ms, 0.75 against 0.64
//   ms).  At 192/128 dK alone takes 96, so 64-position tiles would need
//   96 + 64 + 64 + 32 = 256: the tiles there are 32 positions (S^T and
//   dP^T m64n32k16), 96 + 64 + 32 + 16 = 208.  The dQ warpgroup fits at
//   every pair with 64-key tiles at hd 128 and 192: 96 (dQ) + 32 + 32 +
//   16 = 176 at 192.  Every descriptor is computed where its wgmma is
//   issued (pin()), not hoisted out of the walk.
// * Shared memory (KvLayout, QLayout; a static_assert holds each to the
//   232,448 bytes a block may use): at 192/128 the dK/dV block's K and
//   V (81,920 bytes) and three stages of a 32-position q and dout tile
//   (61,440), the dQ block's q and dout (81,920) and three stages of a
//   64-key K and V tile (122,880).
//
// Three launches:
// 1. stats_kernel: D = rowsum(dout . out) and lse log2(e) for every
//    row, into a scratch buffer (B, H, 2, Sqp), Sqp = Sq rounded up to
//    128, +inf and 0 past Sq (so that a tile's rows past Sq have P = 0
//    and every tile's statistics are one aligned bulk copy).
// 2. dkdv_kernel: a block owns 128 keys of one (b, kv head), each
//    consumer warpgroup 64 of them as the wgmma M dimension.  K and V
//    are loaded once by TMA (the forward's 4-d map over (B, Sk, KVH,
//    width), 128-byte swizzle).  The producer streams, for each of the G
//    heads of the group in turn, the tiles of q and dout (BR positions:
//    128 at 64/64, 64 at 128/128, 32 at 192/128) that see the block's
//    keys, with their statistics.  Each warpgroup computes S^T = K Q^T
//    and dP^T = V dO^T (m64n{BR}k16), then dV += P^T dO (m64n{HDV}k16)
//    and dK += dS^T Q (m64n{HDK}k16) into fp32 registers, written once
//    at the end.  Blocks run by (b, kv head), earliest keys first: those
//    see the most rows.
// 3. dq_kernel: a block owns 128 positions of one (b, head), each
//    consumer warpgroup 64 as M; Q and dout are loaded once by TMA, K
//    and V tiles (128 keys at hd 64, 64 at 128 and 192, which keeps S,
//    dP and dQ within the registers) stream through the ring.  Products
//    S = Q K^T and dP = dO V^T (SS), then dQ += dS K (RS, K as the
//    MN-major B).  Rows are per head, not folded: a K/V tile is read
//    once for each of the G heads, from L2, since the blocks of one
//    (b, kv head) run together; folding would need the forward's
//    per-thread gather of q and dout and a division in every mask.
//    Latest rows first: they walk the most key tiles.
// In both, tiles wholly outside every row's mask are never loaded and
// tiles that all of a warpgroup's pairs see whole skip the per-score
// test.
//
// Measured (chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md
// section 6 gives each run with this file's sha256): at the training
// path's shape (B 8, S 4,096, 9/3 heads of 64, causal) 1.23 ms, 0.32
// of the bound and a third of the first design's.  SDPA's backward
// takes about as long: 1.014 and 0.864 of it in two runs, between
// which SDPA's own time moved from 1.209 to 1.420 ms.  Of the 1.23 ms
// the dK/dV kernel takes about 0.64, dQ 0.45 and the statistics 0.03
// (the train step's profile).  At Qwen3-4B's prefill shape (B 4, S
// 4,096, 32/8 heads of 128) 3.34 to 3.37 ms, 0.41 of the bound, a
// third of the first design's, and 1.016 and 1.006 of SDPA's backward
// in the same two runs.  At 192/128 (B 4, S 4,096, 16 heads, causal):
// not measured yet (PERF.md section 6, row 5b).  The five-product
// design (dQ folded into the dK/dV kernel, its partials summed in key
// order) is not built; it is the next step (PERF.md section 7).

// Layout: q, dq (B, Sq, H, hd); out, dout (B, Sq, H, hdv); k, dk (B, Sk,
// KVH, hd); v, dv (B, Sk, KVH, hdv); all contiguous bf16 (rows 16-byte
// aligned, as TMA needs); lse (B, H, Sq) fp32.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 384;    // producer + two consumer warpgroups
constexpr int WG_ROWS = 64;     // the wgmma M dimension of a warpgroup
constexpr int BK = 128;         // keys a dK/dV block
constexpr int BM = 128;         // positions a dQ block
constexpr int STAGES = 3;       // ring depth
constexpr int LINE = 128;       // bytes of a swizzled shared line (64 bf16)
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const __nv_bfloat16* out;
  const __nv_bfloat16* dout;
  const float* lse;             // (B, H, Sq)
  float* stats;                 // (B, H, 2, Sqp): lse log2(e), then D
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int B, Sq, Sk, H, KVH, Sqp;
  int causal, window, q_offset;
  float scale;                  // 1 / sqrt(hd)
  float scale_log2;             // log2(e) / sqrt(hd)
};

constexpr int SMEM_MAX = 232448;   // shared memory a block may use

// dkdv_kernel's shared memory at q/k width HDK and v width HDV: the
// block's K and V, then STAGES stages of a q tile and a dout tile of BR
// positions, their statistics, the barriers.  Every tile starts on a
// 1,024-byte boundary (the swizzle's atom), its 64-wide column chunks
// BR lines apart.
template <int HDK, int HDV>
struct KvLayout {
  // positions a tile: what the dK/dV registers leave room for (header)
  static constexpr int BR = HDK == 64 ? 128 : HDK == 128 ? 64 : 32;
  static constexpr int KT = BK * HDK * 2;             // K of the block
  static constexpr int VT = BK * HDV * 2;             // V of the block
  static constexpr int QT = BR * HDK * 2;             // one q tile
  static constexpr int GT = BR * HDV * 2;             // one dout tile
  static constexpr int STAGE = QT + GT;
  static constexpr int RING = KT + VT;
  static constexpr int STATS = RING + STAGES * STAGE;
  static constexpr int BAR = STATS + STAGES * 2 * BR * 4;
  static constexpr int SMEM = BAR + (2 * STAGES + 1) * 8 + 1024;
  static_assert(SMEM <= SMEM_MAX, "dkdv_kernel's shared memory");
};

// dq_kernel's: the block's q and dout (a warpgroup's 64 rows each), then
// STAGES stages of a K tile and a V tile of BN keys, the barriers
template <int HDK, int HDV>
struct QLayout {
  static constexpr int BN = HDK == 64 ? 128 : 64;     // keys a tile
  static constexpr int QW = WG_ROWS * HDK * 2;        // a warpgroup's q
  static constexpr int GW = WG_ROWS * HDV * 2;        // a warpgroup's dout
  static constexpr int KT = BN * HDK * 2;             // one K tile
  static constexpr int VT = BN * HDV * 2;             // one V tile
  static constexpr int STAGE = KT + VT;
  static constexpr int RING = 2 * QW + 2 * GW;        // q0 q1 dout0 dout1
  static constexpr int BAR = RING + STAGES * STAGE;
  static constexpr int SMEM = BAR + (2 * STAGES + 1) * 8 + 1024;
  static_assert(SMEM <= SMEM_MAX, "dq_kernel's shared memory");
};

__device__ __forceinline__ bool visible(const Args& a, int n, int qpos) {
  if (n >= a.Sk) return false;
  if (!a.causal) return true;
  if (n > qpos) return false;
  return a.window <= 0 || n > qpos - a.window;
}

// The key tiles [*t0, *t1) of width bn that some position of
// [s0, s0 + BM) can see.
__device__ __forceinline__ void key_tiles(const Args& a, int s0, int bn,
                                          int* t0, int* t1) {
  const int s1 = min(s0 + BM, a.Sq) - 1;
  int k0 = 0, k1 = a.Sk;
  if (a.causal) {
    k1 = max(0, min(a.Sk, a.q_offset + s1 + 1));
    if (a.window > 0) k0 = max(0, a.q_offset + s0 - a.window + 1);
  }
  *t0 = k0 / bn;
  *t1 = k1 > k0 ? (k1 + bn - 1) / bn : *t0;
}

// The row tiles [*t0, *t1) of br positions that some key of
// [n0, n0 + BK) is seen by.
__device__ __forceinline__ void row_tiles(const Args& a, int n0, int br,
                                          int* t0, int* t1) {
  const int n1 = min(n0 + BK, a.Sk) - 1;
  int p0 = 0, p1 = a.Sq - 1;
  if (a.causal) {
    p0 = max(0, n0 - a.q_offset);
    if (a.window > 0) p1 = min(p1, n1 + a.window - 1 - a.q_offset);
  }
  if (p1 < p0) {
    *t0 = *t1 = 0;
    return;
  }
  *t0 = p0 / br;
  *t1 = p1 / br + 1;
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

// ---- TMA, bulk copies, named barriers ----------------------------------

// one box (64 hd x 1 head x rows x 1 batch) of a 4-d tensor map
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

// bytes (a multiple of 16) from 16-byte aligned global memory
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
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

// x, as a value the compiler cannot see through: a descriptor computed
// from it is computed where it is used, not hoisted out of the tile loop
// with all the others (the K and V tiles' (HDK + HDV) / 16 descriptors
// of 64 bits each would hold 32 registers at 128/128 for the whole walk)
__device__ __forceinline__ uint32_t pin(uint32_t x) {
  uint32_t y;
  asm volatile("mov.b32 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// two floats of shared memory, read where the code reads them
__device__ __forceinline__ float2 lds2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr));
  return v;
}

// a K-major operand: rows lines of 128 bytes a 64-wide chunk, chunks
// `rows` lines apart; the 16-wide step kk of the contraction
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int kk) {
  return desc_sw128(tile + (kk / 4) * rows * LINE + (kk % 4) * 32, 16, 1024);
}

// an MN-major B operand (rows along the contraction, hd along N): the
// 16 rows of step kk, its 64-wide N chunks `rows` lines apart
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int kk) {
  return desc_sw128(tile + kk * 16 * LINE, rows * LINE, 1024);
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

// d (64 x 64 fp32) (+)= A (64 x 16, smem, K-major) B^T (64 x 16, smem,
// K-major); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128 fp32) (+)= A (64 x 16, smem, K-major) B^T (128 x 16, smem,
// K-major); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
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

// d (64 x 32 fp32) (+)= A (64 x 16, smem, K-major) B^T (32 x 16, smem,
// K-major); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 32 fp32) = A (64 x 16, smem, K-major) B^T (32 x 16, smem,
// K-major): the first product of a chain, which overwrites d, so that d's
// old values are dead before it
__device__ __forceinline__ void wgmma_ss_n32_first(float* d, uint64_t da,
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
        "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
        "=f"(d[15])
      : "l"(da), "l"(db));
}

// d (64 x 64 fp32) = A (64 x 16, smem, K-major) B^T (64 x 16, smem,
// K-major): the first product of a chain, which overwrites d, so that d's
// old values are dead before it
__device__ __forceinline__ void wgmma_ss_n64_first(float* d, uint64_t da,
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
        "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
        "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
        "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db));
}

// d (64 x 128 fp32) = A (64 x 16, smem, K-major) B^T (128 x 16, smem,
// K-major): the first product of a chain, which overwrites d, so that d's
// old values are dead before it
__device__ __forceinline__ void wgmma_ss_n128_first(float* d, uint64_t da,
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 0, 0;\n"
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
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
        "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
        "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
        "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]),
        "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]),
        "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]), "=f"(d[49]),
        "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]),
        "=f"(d[55]), "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db));
}

// d (64 x N) = A B^T, the first product of a chain
template <int N>
__device__ __forceinline__ void wgmma_ss_first(float* d, uint64_t da,
                                               uint64_t db) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_ss_first's N");
  if constexpr (N == 128)
    wgmma_ss_n128_first(d, da, db);
  else if constexpr (N == 64)
    wgmma_ss_n64_first(d, da, db);
  else
    wgmma_ss_n32_first(d, da, db);
}

// d (64 x N) (+)= A B^T, both K-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_ss's N");
  if constexpr (N == 128)
    wgmma_ss_n128(d, da, db, scale_d);
  else if constexpr (N == 64)
    wgmma_ss_n64(d, da, db, scale_d);
  else
    wgmma_ss_n32(d, da, db, scale_d);
}

// d (64 x N) += A (registers) B, B the 16 rows of step kk of an
// MN-major tile whose 64-wide N chunks lie `rows` lines apart
// (desc_mn).  N = 192 is an n128 product over chunks 0 and 1 and an n64
// over chunk 2: the accumulator fragment of m64n192 is theirs side by
// side (8-column groups in order, four floats each).
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4],
                                         uint32_t tile, int rows, int kk) {
  static_assert(N == 64 || N == 128 || N == 192, "wgmma_rs's N");
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, desc_mn(tile, rows, kk));
  } else {
    wgmma_rs_n128(d, a, desc_mn(tile, rows, kk));
    if constexpr (N == 192)
      wgmma_rs_n64(d + 64, a, desc_mn(tile + 2 * rows * LINE, rows, kk));
  }
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

// an m64nN accumulator fragment (N / 2 fp32 a thread) rounded to bf16 as
// the A fragments of its N / 16 steps of 16 along the contraction
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&f)[N / 16][4],
                                       const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    f[kk][0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
    f[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    f[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    f[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// a warpgroup's 64 x HD fp32 accumulator (HD / 64 chunks of 32 floats a
// thread) as bf16 rows: this thread's rows r0 (fragment rows lane / 4)
// and r0 + 8 at element offsets off_lo and off_hi, each written when its
// flag is set
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst,
                                           const float* acc, int64_t off_lo,
                                           bool ok_lo, int64_t off_hi,
                                           bool ok_hi, int cq) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (!(half ? ok_hi : ok_lo)) continue;
    __nv_bfloat16* row = dst + (half ? off_hi : off_lo);
#pragma unroll
    for (int c = 0; c < HD / 64; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(row + c * 64 + i * 8 + cq) =
            __floats2bfloat162_rn(acc[c * 32 + 4 * i + 2 * half],
                                  acc[c * 32 + 4 * i + 2 * half + 1]);
  }
}

// ---- 1. row statistics -----------------------------------------------

// one group of HDV / 8 threads a row (b, h, s) of the padded (B, H,
// Sqp): 16 bytes of out and dout (v's width HDV) a thread
template <int HDV>
__global__ void __launch_bounds__(256) stats_kernel(const Args a) {
  constexpr int PER = HDV / 8;
  const int64_t i = blockIdx.x * 256LL + threadIdx.x;
  const int64_t row = i / PER;
  const int piece = (int)(i % PER);
  const int64_t rows = (int64_t)a.B * a.H * a.Sqp;
  const int64_t bh = row / a.Sqp;
  const int s = (int)(row % a.Sqp);
  float acc = 0.f, l2 = INFINITY;
  if (row < rows && s < a.Sq) {
    const int64_t b = bh / a.H, h = bh % a.H;
    const int64_t off = ((b * a.Sq + s) * a.H + h) * HDV + piece * 8;
    const uint4 o = *reinterpret_cast<const uint4*>(a.out + off);
    const uint4 g = *reinterpret_cast<const uint4*>(a.dout + off);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 of = __bfloat1622float2(o2[e]);
      const float2 gf = __bfloat1622float2(g2[e]);
      acc = fmaf(gf.x, of.x, acc);
      acc = fmaf(gf.y, of.y, acc);
    }
    l2 = a.lse[bh * a.Sq + s] * LOG2E;
  }
#pragma unroll
  for (int off = PER / 2; off >= 1; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && piece == 0) {
    a.stats[(bh * 2) * a.Sqp + s] = l2;
    a.stats[(bh * 2 + 1) * a.Sqp + s] = acc;
  }
}

// ---- 2. dK, dV ---------------------------------------------------------

template <int HDK, int HDV>
__global__ void __launch_bounds__(THREADS, 1)
    dkdv_kernel(const __grid_constant__ CUtensorMap tmk,
                const __grid_constant__ CUtensorMap tmv,
                const __grid_constant__ CUtensorMap tmq,
                const __grid_constant__ CUtensorMap tmg, const Args a) {
  using L = KvLayout<HDK, HDV>;
  constexpr int BR = L::BR;
  extern __shared__ unsigned char smem_raw[];
  // swizzle atoms (8 lines of 128 bytes) start on 1024-byte boundaries
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  // full[s], empty[s], then the block's K and V
  const uint32_t bars = base + L::BAR;
#define FULL(s) (bars + 8 * (s))
#define EMPTY(s) (bars + 8 * (STAGES + (s)))
#define KV_FULL (bars + 8 * 2 * STAGES)

  const int G = a.H / a.KVH;
  const int n_kb = (a.Sk + BK - 1) / BK;
  // blocks by (batch, kv head), so that the blocks at work share the
  // group's q and dout in L2; within each the earliest keys, which see
  // the most rows, first
  const int kb = (int)(blockIdx.x % n_kb);
  const int bh = (int)(blockIdx.x / n_kb);
  const int b = bh / a.KVH, kvh = bh % a.KVH;
  const int n0 = kb * BK;
  int t0, t1;
  row_tiles(a, n0, BR, &t0, &t1);
  const int nt = t1 - t0;
  const int n = nt * G;    // tiles: the G heads one after another

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(FULL(s), 1);
      mbar_init(EMPTY(s), 8);   // one arrival a consumer warp
    }
    mbar_init(KV_FULL, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the ring full --------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0 && n > 0) {
      mbar_expect_tx(KV_FULL, L::KT + L::VT);
#pragma unroll
      for (int c = 0; c < HDK / 64; ++c)
        tma_load(base + c * BK * LINE, &tmk, KV_FULL, c * 64, kvh, n0, b);
#pragma unroll
      for (int c = 0; c < HDV / 64; ++c)
        tma_load(base + L::KT + c * BK * LINE, &tmv, KV_FULL, c * 64, kvh,
                 n0, b);
      for (int j = 0; j < n; ++j) {
        const int s = j % STAGES;
        const uint32_t ph = ((j / STAGES) & 1) ^ 1;   // first round free
        const int h = kvh * G + j / nt;
        const int p0 = (t0 + j % nt) * BR;
        const uint32_t qs = base + L::RING + s * L::STAGE;
        const float* st = a.stats + (int64_t)(b * a.H + h) * 2 * a.Sqp + p0;
        mbar_wait(EMPTY(s), ph);
        mbar_expect_tx(FULL(s), L::STAGE + 2 * BR * 4);
#pragma unroll
        for (int c = 0; c < HDK / 64; ++c)
          tma_load(qs + c * BR * LINE, &tmq, FULL(s), c * 64, h, p0, b);
#pragma unroll
        for (int c = 0; c < HDV / 64; ++c)
          tma_load(qs + L::QT + c * BR * LINE, &tmg, FULL(s), c * 64, h, p0,
                   b);
        const uint32_t ss = base + L::STATS + s * 2 * BR * 4;
        bulk_load(ss, st, BR * 4, FULL(s));
        bulk_load(ss + BR * 4, st + a.Sqp, BR * 4, FULL(s));
      }
    }
  } else {
    // ---- consumers: 64 keys each -------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int nw0 = n0 + cw * WG_ROWS;
    // this thread's two keys of every accumulator: g and g + 8
    const int key_lo = nw0 + warp * 16 + lane / 4, key_hi = key_lo + 8;
    const int cq = 2 * (lane % 4);   // first column of a fragment
    const uint32_t ks = base + cw * WG_ROWS * LINE;   // K chunk c: + c BK LINE
    const uint32_t vs = ks + L::KT;

    float dk[HDK / 2], dv[HDV / 2];
#pragma unroll
    for (int i = 0; i < HDK / 2; ++i) dk[i] = 0.f;
#pragma unroll
    for (int i = 0; i < HDV / 2; ++i) dv[i] = 0.f;
    float sacc[BR / 2], pacc[BR / 2];   // S^T and dP^T, then P^T and dS^T
    uint32_t pa[BR / 16][4], da[BR / 16][4];   // P^T, dS^T as bf16

    if (n > 0) {
      mbar_wait(KV_FULL, 0);
      // the first turn at the tensor cores is consumer 0's
      if (cw == 1) bar_arrive(1, 256);
      // S^T = K Q^T and dP^T = V dO^T of tile j, issued and committed
      auto issue_s = [&](int j) {
        const int s = j % STAGES;
        const uint32_t qs = base + L::RING + s * L::STAGE;
        mbar_wait(FULL(s), (j / STAGES) & 1);
        wg_fence();
        wgmma_ss_first<BR>(sacc, desc_k(pin(ks), BK, 0),
                           desc_k(pin(qs), BR, 0));
#pragma unroll
        for (int kk = 1; kk < HDK / 16; ++kk)
          wgmma_ss<BR>(sacc, desc_k(pin(ks), BK, kk), desc_k(pin(qs), BR, kk),
                       1);
        wgmma_ss_first<BR>(pacc, desc_k(pin(vs), BK, 0),
                           desc_k(pin(qs + L::QT), BR, 0));
#pragma unroll
        for (int kk = 1; kk < HDV / 16; ++kk)
          wgmma_ss<BR>(pacc, desc_k(pin(vs), BK, kk),
                       desc_k(pin(qs + L::QT), BR, kk), 1);
        wg_commit();
      };
      // dV += P^T dO and dK += dS^T Q of tile j, issued and committed
      auto issue_kv = [&](int j) {
        const uint32_t qs = base + L::RING + (j % STAGES) * L::STAGE;
        fence_regs(dk);
        fence_regs(dv);
        fence_regs(pa);
        fence_regs(da);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BR / 16; ++kk) {
          wgmma_rs<HDV>(dv, pa[kk], pin(qs + L::QT), BR, kk);
          wgmma_rs<HDK>(dk, da[kk], pin(qs), BR, kk);
        }
        wg_commit();
      };
      // the mask (only where some pair of the tile is hidden), then
      // P^T = exp2(S^T scale_log2 - lse2) and dS^T = P^T (dP^T - D) scale
      // in place, fp32
      auto form = [&](int j) {
        const int s = j % STAGES;
        const int p0 = (t0 + j % nt) * BR;
        const uint32_t st = base + L::STATS + s * 2 * BR * 4 + cq * 4;
        const int qlo = a.q_offset + p0;
        const int qhi = a.q_offset + min(p0 + BR, a.Sq) - 1;
        const bool whole = !a.causal || (visible(a, nw0 + WG_ROWS - 1, qlo) &&
                                         visible(a, nw0, qhi));
        if (!whole) {
#pragma unroll
          for (int i = 0; i < BR / 8; ++i) {
            const int qp = qlo + i * 8 + cq;
            if (!visible(a, key_lo, qp)) sacc[4 * i] = -INFINITY;
            if (!visible(a, key_lo, qp + 1)) sacc[4 * i + 1] = -INFINITY;
            if (!visible(a, key_hi, qp)) sacc[4 * i + 2] = -INFINITY;
            if (!visible(a, key_hi, qp + 1)) sacc[4 * i + 3] = -INFINITY;
          }
        }
#pragma unroll
        for (int i = 0; i < BR / 8; ++i) {
          const float2 l = lds2(pin(st) + i * 32);
          const float2 d = lds2(pin(st) + BR * 4 + i * 32);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x =
                ex2(fmaf(sacc[4 * i + e], a.scale_log2, e & 1 ? -l.y : -l.x));
            sacc[4 * i + e] = x;
            pacc[4 * i + e] = x * (pacc[4 * i + e] - (e & 1 ? d.y : d.x)) *
                              a.scale;
          }
        }
      };

      // tile 0: S and dP alone.  Each turn at the tensor cores ends by
      // handing it to the other warpgroup, but consumer 1's last:
      // consumer 0 takes no turn after it.
      bar_sync(1 + cw, 256);
      issue_s(0);
      if (!(cw == 1 && n == 1)) bar_arrive(2 - cw, 256);
      wg_wait<0>();
      fence_regs(sacc);
      fence_regs(pacc);
      form(0);
      pack_a<BR>(pa, sacc);
      pack_a<BR>(da, pacc);
      // tile j: in this warpgroup's turn, the RS products of tile j - 1,
      // drained before S and dP of tile j are issued (so that P^T and
      // dS^T are dead while S^T and dP^T are written: 64 registers a
      // thread that the turn does not hold twice); then tile j's P and dS
      // while the other warpgroup's products run
      for (int j = 1; j < n; ++j) {
        bar_sync(1 + cw, 256);
        issue_kv(j - 1);
        wg_wait<0>();   // dV, dK of tile j - 1
        fence_regs(dk);
        fence_regs(dv);
        fence_regs(pa);
        fence_regs(da);
        if (lane == 0) mbar_arrive(EMPTY((j - 1) % STAGES));
        issue_s(j);
        if (!(cw == 1 && j == n - 1)) bar_arrive(2 - cw, 256);
        wg_wait<0>();   // S and dP of tile j
        fence_regs(sacc);
        fence_regs(pacc);
        form(j);
        pack_a<BR>(pa, sacc);
        pack_a<BR>(da, pacc);
      }
      issue_kv(n - 1);   // the last tile's RS products
      wg_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      if (lane == 0) mbar_arrive(EMPTY((n - 1) % STAGES));
    }

    // one write of each key's rows (a key seen by no row is 0)
    const int64_t key = ((int64_t)b * a.Sk + key_lo) * a.KVH + kvh;
    const int64_t step = 8LL * a.KVH;   // key_hi's row is 8 keys on
    store_rows<HDK>(a.dk, dk, key * HDK, key_lo < a.Sk, (key + step) * HDK,
                    key_hi < a.Sk, cq);
    store_rows<HDV>(a.dv, dv, key * HDV, key_lo < a.Sk, (key + step) * HDV,
                    key_hi < a.Sk, cq);
  }
#undef FULL
#undef EMPTY
#undef KV_FULL
}

// ---- 3. dQ ---------------------------------------------------------------

template <int HDK, int HDV>
__global__ void __launch_bounds__(THREADS, 1)
    dq_kernel(const __grid_constant__ CUtensorMap tmq,
              const __grid_constant__ CUtensorMap tmg,
              const __grid_constant__ CUtensorMap tmk,
              const __grid_constant__ CUtensorMap tmv, const Args a) {
  using L = QLayout<HDK, HDV>;
  constexpr int BN = L::BN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bars = base + L::BAR;
#define FULL(s) (bars + 8 * (s))
#define EMPTY(s) (bars + 8 * (STAGES + (s)))
#define Q_FULL (bars + 8 * 2 * STAGES)

  const int G = a.H / a.KVH;
  const int n_rb = (a.Sq + BM - 1) / BM;
  // blocks by (batch, head), so that the G heads of a kv head, whose
  // blocks read the same K/V tiles, run together; within each the
  // latest rows, which walk the most key tiles, first
  const int rb = n_rb - 1 - (int)(blockIdx.x % n_rb);
  const int bh = (int)(blockIdx.x / n_rb);
  const int b = bh / a.H, h = bh % a.H, kvh = h / G;
  const int s0 = rb * BM;
  int t0, t1;
  key_tiles(a, s0, BN, &t0, &t1);
  const int n = t1 - t0;   // both consumers walk all of them

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(FULL(s), 1);
      mbar_init(EMPTY(s), 8);
    }
    mbar_init(Q_FULL, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0 && n > 0) {
      mbar_expect_tx(Q_FULL, L::RING);
#pragma unroll
      for (int w = 0; w < 2; ++w) {
#pragma unroll
        for (int c = 0; c < HDK / 64; ++c)
          tma_load(base + w * L::QW + c * WG_ROWS * LINE, &tmq, Q_FULL,
                   c * 64, h, s0 + w * WG_ROWS, b);
#pragma unroll
        for (int c = 0; c < HDV / 64; ++c)
          tma_load(base + 2 * L::QW + w * L::GW + c * WG_ROWS * LINE, &tmg,
                   Q_FULL, c * 64, h, s0 + w * WG_ROWS, b);
      }
      for (int j = 0; j < n; ++j) {
        const int s = j % STAGES;
        const uint32_t ph = ((j / STAGES) & 1) ^ 1;
        const int key = (t0 + j) * BN;
        const uint32_t ks = base + L::RING + s * L::STAGE;
        mbar_wait(EMPTY(s), ph);
        mbar_expect_tx(FULL(s), L::STAGE);
#pragma unroll
        for (int c = 0; c < HDK / 64; ++c)
          tma_load(ks + c * BN * LINE, &tmk, FULL(s), c * 64, kvh, key, b);
#pragma unroll
        for (int c = 0; c < HDV / 64; ++c)
          tma_load(ks + L::KT + c * BN * LINE, &tmv, FULL(s), c * 64, kvh,
                   key, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int Rw = s0 + cw * WG_ROWS;
    const uint32_t qs = base + cw * L::QW;
    const uint32_t gs = base + 2 * L::QW + cw * L::GW;
    // this thread's two rows of every accumulator: g and g + 8
    const int r_lo = Rw + warp * 16 + lane / 4, r_hi = r_lo + 8;
    const int qpos_lo = a.q_offset + r_lo, qpos_hi = a.q_offset + r_hi;
    // a tile that the warpgroup's first and last valid rows see whole
    // is seen whole by every row between them
    const int wpos_lo = a.q_offset + Rw;
    const int wpos_hi = a.q_offset + max(Rw, min(Rw + WG_ROWS, a.Sq) - 1);
    const int cq = 2 * (lane % 4);
    // the rows' statistics (Sqp is a multiple of BM: every row has one)
    const float* st = a.stats + (int64_t)(b * a.H + h) * 2 * a.Sqp;
    const float l2_lo = st[r_lo], l2_hi = st[r_hi];
    const float d_lo = st[a.Sqp + r_lo], d_hi = st[a.Sqp + r_hi];

    float dq[HDK / 2];
#pragma unroll
    for (int i = 0; i < HDK / 2; ++i) dq[i] = 0.f;
    float sacc[BN / 2], pacc[BN / 2];   // S and dP, then P and dS
    uint32_t da[BN / 16][4];            // dS as bf16

    if (n > 0) {
      mbar_wait(Q_FULL, 0);
      if (cw == 1) bar_arrive(1, 256);
      // S = Q K^T and dP = dO V^T of tile j, issued and committed
      auto issue_s = [&](int j) {
        const int s = j % STAGES;
        const uint32_t ks = base + L::RING + s * L::STAGE;
        mbar_wait(FULL(s), (j / STAGES) & 1);
        fence_regs(sacc);
        fence_regs(pacc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < HDK / 16; ++kk)
          wgmma_ss<BN>(sacc, desc_k(pin(qs), WG_ROWS, kk),
                       desc_k(pin(ks), BN, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < HDV / 16; ++kk)
          wgmma_ss<BN>(pacc, desc_k(pin(gs), WG_ROWS, kk),
                       desc_k(pin(ks + L::KT), BN, kk), kk > 0);
        wg_commit();
      };
      // dQ += dS K of tile j, issued and committed
      auto issue_dq = [&](int j) {
        const uint32_t ks = base + L::RING + (j % STAGES) * L::STAGE;
        fence_regs(dq);
        fence_regs(da);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_rs<HDK>(dq, da[kk], pin(ks), BN, kk);
        wg_commit();
      };
      // the mask, then P = exp2(S scale_log2 - lse2) and
      // dS = P (dP - D) scale in place, fp32
      auto form = [&](int j) {
        const int n0 = (t0 + j) * BN;
        const bool whole = n0 + BN - 1 < a.Sk &&
                           visible(a, n0 + BN - 1, wpos_lo) &&
                           visible(a, n0, wpos_hi);
        if (!whole) {
#pragma unroll
          for (int i = 0; i < BN / 8; ++i) {
            const int nk = n0 + i * 8 + cq;
            if (!visible(a, nk, qpos_lo)) sacc[4 * i] = -INFINITY;
            if (!visible(a, nk + 1, qpos_lo)) sacc[4 * i + 1] = -INFINITY;
            if (!visible(a, nk, qpos_hi)) sacc[4 * i + 2] = -INFINITY;
            if (!visible(a, nk + 1, qpos_hi)) sacc[4 * i + 3] = -INFINITY;
          }
        }
#pragma unroll
        for (int i = 0; i < BN / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = ex2(
                fmaf(sacc[4 * i + e], a.scale_log2, e < 2 ? -l2_lo : -l2_hi));
            sacc[4 * i + e] = x;
            pacc[4 * i + e] =
                x * (pacc[4 * i + e] - (e < 2 ? d_lo : d_hi)) * a.scale;
          }
      };

      bar_sync(1 + cw, 256);
      issue_s(0);
      if (!(cw == 1 && n == 1)) bar_arrive(2 - cw, 256);
      wg_wait<0>();
      fence_regs(sacc);
      fence_regs(pacc);
      form(0);
      pack_a<BN>(da, pacc);
      for (int j = 1; j < n; ++j) {
        bar_sync(1 + cw, 256);
        issue_s(j);
        issue_dq(j - 1);
        if (!(cw == 1 && j == n - 1)) bar_arrive(2 - cw, 256);
        wg_wait<1>();   // S and dP of tile j
        fence_regs(sacc);
        fence_regs(pacc);
        form(j);
        wg_wait<0>();   // dQ of tile j - 1
        fence_regs(dq);
        fence_regs(da);
        if (lane == 0) mbar_arrive(EMPTY((j - 1) % STAGES));
        pack_a<BN>(da, pacc);
      }
      issue_dq(n - 1);
      wg_wait<0>();
      fence_regs(dq);
      if (lane == 0) mbar_arrive(EMPTY((n - 1) % STAGES));
    }

    // one write of each row (a row that sees no key is 0)
    const int64_t off_lo = (((int64_t)b * a.Sq + r_lo) * a.H + h) * HDK;
    const int64_t off_hi = off_lo + 8LL * a.H * HDK;
    store_rows<HDK>(a.dq, dq, off_lo, r_lo < a.Sq, off_hi, r_hi < a.Sq, cq);
  }
#undef FULL
#undef EMPTY
#undef Q_FULL
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

// a contiguous (B, S, NH, hd) bf16 array as a 4-d map: dims (hd, NH, S,
// B); boxes of 64 x 1 x rows x 1, 128-byte swizzle, zeros past S.  A
// dimension of size 1 never moves the address, so its stride is given
// as the packed one (the same either way for a contiguous array).
CUresult make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr,
                  int64_t B, int64_t S, int64_t NH, int64_t hd, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)NH, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(hd * 2),
                                 (cuuint64_t)(NH * hd * 2),
                                 (cuuint64_t)(S * NH * hd * 2)};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int HDK, int HDV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const Args& a, cudaStream_t st) {
  using KL = KvLayout<HDK, HDV>;
  using QL = QLayout<HDK, HDV>;
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (cudaError_t)999;
  // q and k at q/k's width, v and dout at v's
  CUtensorMap kk, kv, kq, kg, qq, qg, qk, qv;
  CUresult r = make_map(enc, &kk, k, a.B, a.Sk, a.KVH, HDK, BK);
  if (r == CUDA_SUCCESS) r = make_map(enc, &kv, v, a.B, a.Sk, a.KVH, HDV, BK);
  if (r == CUDA_SUCCESS)
    r = make_map(enc, &kq, q, a.B, a.Sq, a.H, HDK, KL::BR);
  if (r == CUDA_SUCCESS)
    r = make_map(enc, &kg, a.dout, a.B, a.Sq, a.H, HDV, KL::BR);
  if (r == CUDA_SUCCESS)
    r = make_map(enc, &qq, q, a.B, a.Sq, a.H, HDK, WG_ROWS);
  if (r == CUDA_SUCCESS)
    r = make_map(enc, &qg, a.dout, a.B, a.Sq, a.H, HDV, WG_ROWS);
  if (r == CUDA_SUCCESS)
    r = make_map(enc, &qk, k, a.B, a.Sk, a.KVH, HDK, QL::BN);
  if (r == CUDA_SUCCESS)
    r = make_map(enc, &qv, v, a.B, a.Sk, a.KVH, HDV, QL::BN);
  if (r != CUDA_SUCCESS) return (cudaError_t)(1000 + (int)r);

  const int64_t stat_threads = (int64_t)a.B * a.H * a.Sqp * (HDV / 8);
  stats_kernel<HDV>
      <<<(unsigned)((stat_threads + 255) / 256), 256, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int kv_bytes = KL::SMEM;
  err = cudaFuncSetAttribute(dkdv_kernel<HDK, HDV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kv_bytes);
  if (err != cudaSuccess) return err;
  const int64_t kv_blocks = (int64_t)(a.Sk + BK - 1) / BK * a.B * a.KVH;
  dkdv_kernel<HDK, HDV><<<(unsigned)kv_blocks, THREADS, kv_bytes, st>>>(
      kk, kv, kq, kg, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int q_bytes = QL::SMEM;
  err = cudaFuncSetAttribute(dq_kernel<HDK, HDV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             q_bytes);
  if (err != cudaSuccess) return err;
  const int64_t q_blocks = (int64_t)(a.Sq + BM - 1) / BM * a.B * a.H;
  dq_kernel<HDK, HDV><<<(unsigned)q_blocks, THREADS, q_bytes, st>>>(
      qq, qg, qk, qv, a);
  return cudaGetLastError();
}

}  // namespace

// The arguments of flash_bwd.cu's entry.  q, dq (B, Sq, H, hd); out,
// dout (B, Sq, H, hdv); k, dk (B, Sk, KVH, hd); v, dv (B, Sk, KVH, hdv);
// lse (B, H, Sq) fp32; all contiguous bf16 device pointers but lse,
// 16-byte aligned.  delta is a scratch buffer of 2 B H Sqp fp32 this
// call writes, Sqp = Sq rounded up to a multiple of 128.  is_bf16 must
// be 1 and (hd, hdv) one of (64, 64), (128, 128) and (192, 128); the
// scale is 1 / sqrt(hd).  The caller has checked shapes and 0 <=
// q_offset, 0 <= window.  Error codes besides cudaError_t: 1000 + the
// CUresult of a tensor map that did not encode, 999 when the driver has
// no cuTensorMapEncodeTiled.
extern "C" int flash_bwd_sm90(const void* q, const void* k, const void* v,
                              const void* out, const void* dout,
                              const void* lse, void* delta, void* dq,
                              void* dk, void* dv, int64_t B, int64_t Sq,
                              int64_t Sk, int64_t H, int64_t KVH, int64_t hd,
                              int64_t hdv, int64_t causal, int64_t window,
                              int64_t q_offset, int64_t is_bf16,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool pair = (hd == 64 && hdv == 64) || (hd == 128 && hdv == 128) ||
                    (hd == 192 && hdv == 128);
  if (!is_bf16 || !pair) return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  // a call with no key has dq 0, one with no query dk and dv 0
  if (Sk <= 0 || Sq <= 0) {
    cudaError_t err = cudaSuccess;
    if (Sq > 0) err = cudaMemsetAsync(dq, 0, (size_t)(B * Sq * H * hd * 2), st);
    if (Sk > 0 && err == cudaSuccess)
      err = cudaMemsetAsync(dk, 0, (size_t)(B * Sk * KVH * hd * 2), st);
    if (Sk > 0 && err == cudaSuccess)
      err = cudaMemsetAsync(dv, 0, (size_t)(B * Sk * KVH * hdv * 2), st);
    return (int)err;
  }
  const int64_t Sqp = (Sq + BM - 1) / BM * BM;
  if ((Sk + BK - 1) / BK * B * KVH > 0x7fffffff ||
      (Sq + BM - 1) / BM * B * H > 0x7fffffff)
    return (int)cudaErrorInvalidConfiguration;
  Args a;
  a.out = static_cast<const __nv_bfloat16*>(out);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.stats = static_cast<float*>(delta);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.B = (int)B;
  a.Sq = (int)Sq;
  a.Sk = (int)Sk;
  a.H = (int)H;
  a.KVH = (int)KVH;
  a.Sqp = (int)Sqp;
  a.causal = (int)causal;
  a.window = (int)window;
  a.q_offset = (int)q_offset;
  a.scale = (float)(1.0 / sqrt((double)hd));
  a.scale_log2 = (float)(1.4426950408889634 / sqrt((double)hd));
  if (hd == 64) return (int)launch<64, 64>(q, k, v, a, st);
  if (hd == 128) return (int)launch<128, 128>(q, k, v, a, st);
  return (int)launch<192, 128>(q, k, v, a, st);
}
