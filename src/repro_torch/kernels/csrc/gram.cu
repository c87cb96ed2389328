// Masked per-row Gram and right-hand side, fp32, for Hopper (sm_90a),
// with the fixed factor's gather in its loads and the precision's
// alpha and Lambda_p in its epilogue.
//
//   g[r]   = sum_t mask[r,t] * v_t v_t^T          (K x K)
//   b[r]   = sum_t mask[r,t] * val[r,t] * v_t     (K)
//   v_t    = fixed[idx[r,t], :]   (gathered entry)   or vg[r,t,:]
//   out[r] = (g[r] * alpha + acc[r]) + lam    rhs[r] = b[r] * alpha + acc
//
// Replaces the Pallas-TPU kernel src/repro/kernels/gram.py
// (gram_pallas / _gram_kernel, pallas_call at line 83), which walks a
// (row-block, nnz-block) grid in order over a pre-gathered slab and
// accumulates each row block's output in VMEM across the nnz axis.
//
// What bounds it on an H100.  At K = 128 a row writes K*K*4 = 64 KB
// and does K(K+1)/2 + K fused multiply-adds a nonzero.  Rows of 64
// nonzeros (131,072 compounds of the slice) are bound by the bytes
// written: the FMAs they need take 0.8 of the time the stores take.
// Columns of about 1,024 nonzeros (8,192 proteins) are bound by the
// fp32 FMA rate (67 TFLOP/s outside the tensor cores).  So the design
// does no more FMAs than the lower triangle, moves each byte once, and
// lets the stores drain while the FMAs run:
//
// * persistent blocks, one an SM, of two groups of 4 warps; a group
//   owns one row at a time and walks its rows (G, G + 2 * grid, ...).
//   Its threads copy the rows fixed[idx[r,t]] (or vg[r,t]) with
//   cp.async, 16 bytes a lane (zeros stored where idx is out of range
//   or t >= T), with val and mask, into a ring of STAGES stages of CH
//   steps, reading idx two stages ahead: the (R, T, K) slab never
//   exists in device memory.  A named barrier a stage keeps the
//   group's 4 warps together;
// * only the lower triangle is computed, each element once, in 8 x 8
//   register tiles over the index sets S(X) = {4X..4X+3} u
//   {64+4X..64+4X+3}, X = 0..15 (two float4 a set, conflict-free in
//   shared memory).  Two warps ("ONE") own the 64 tiles S(I) x S(J),
//   I = 8..15, J = 0..7, and the diagonal elements of S(0..7); two
//   ("TWO") own the 56 tiles below the diagonal within S(0..7) and
//   within S(8..15), and 8 pair lanes that each take the part of
//   diagonal tile d strictly below its diagonal and the part of tile
//   15 - d on and above it (a select per operand keeps their FMA
//   instructions the warp's): 128 lanes x 64 FMAs + 64 = 8,256 =
//   K(K+1)/2 a step, 0.50 of K^2, and the rhs one more a lane.  The
//   second group swaps the roles of its warps, so each sub-partition
//   of the SM runs one ONE and one TWO warp;
// * every output element is one fmaf chain over t, ascending from
//   0.0f, with the masked operand formed as v * mask and the rhs as
//   fmaf(v, val * mask, .).  These are the float programs of the first
//   design (scripts_dev/gram_v1.cu), so for masks of 0 and 1 (those of
//   the sparse layout) the two give the same bits; t is never split,
//   so a row's result is the same on every run;
// * the epilogue forms x = g * alpha, then acc + x, then x + lam[i][j]
//   at each place (i, j) with __fmul_rn / __fadd_rn (no contraction):
//   the rounding of the separate mul_, add_, add_ it replaces.  lam is
//   added at each place's own index, so a lam that is not symmetric
//   gives a result that is not.  alpha is read on the device, lam is
//   held in shared memory.  Each thread stores its tile and its mirror
//   as float4s straight from its registers (the pair lanes' triangles
//   go through shared memory first), so a row's 64 KB drains while the
//   group's next row, and the other group, run their FMAs; acc may be
//   the output itself;
// * for K > 128 a tiled path (the first design's: a block a row and
//   128 x 128 tile pair, two launches) computes the same function;
// * an idx outside [0, n_fixed) is never read: its row counts as zeros
//   (the wrapper adds no host sync to check; the sparse layout never
//   holds one).  Ragged T and K are masked in the kernel;
// * bf16 operand rows (the reference's bf16_gather: gram_bf16 on the
//   pre-gathered slab, gram_gathered_bf16 on the sweep's bf16 copy of
//   the fixed factor, 2-byte elements copied through idx as fp32 rows
//   are) are widened exactly to fp32 where the FMAs read them; the
//   masked operand and val * mask are rounded to bf16 as the
//   reference's bf16 program does (its gram_ref rounds val * mask to
//   bf16 before the rhs product), and the FMA chain is fp32: a product
//   of two bf16 values is exact in fp32.  alpha, acc and lam enter in
//   the same fp32 epilogue.  The ring stages hold half the bytes a row;
//   the (R, K, K) fp32 writes, which bound the rows' half-sweep, do
//   not shrink.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;      // output tile edge
constexpr int CH = 32;         // t steps a ring stage
constexpr int UNROLL = 4;      // steps unrolled in the FMA loop
constexpr int STAGES = 4;
constexpr int GROUP_THREADS = 128;   // 4 warps own a row at a time
constexpr int GROUPS = 2;            // rows in flight a block
constexpr int THREADS = GROUPS * GROUP_THREADS;

struct Params {
  const void* src;      // fixed (n_src, K) or vg (R*T, K), Tin
  const int* idx;       // (R, T) int32, null: pre-gathered
  const float* val;     // (R, T)
  const float* mask;    // (R, T)
  const float* alpha;   // 0-d, null: 1
  const float* acc_g;   // (R, K, K) or null
  const float* acc_r;   // (R, K) or null
  const float* lam;     // (K, K) or null
  float* out_g;         // (R, K, K), may be acc_g
  float* out_r;         // (R, K), may be acc_r
  int64_t R, T, K, n_src;
  int copy16;           // rows by 16-byte cp.async (else plain loads)
  int vec;              // float4 epilogue (K % 4 == 0, out, acc aligned)
};

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// operand types
// ---------------------------------------------------------------------------

template <typename Tin>
struct In;

template <>
struct In<float> {
  __device__ static float get(const float* p, int64_t i) { return p[i]; }
  // the masked operand and val * mask as the reference forms them
  __device__ static float masked(float v, float m) { return __fmul_rn(v, m); }
  __device__ static float round(float x) { return x; }
  // 4 consecutive elements at p (16-byte aligned)
  __device__ static void load4(const float* p, float* o) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  }
};

template <>
struct In<__nv_bfloat16> {
  __device__ static float get(const __nv_bfloat16* p, int64_t i) {
    return __bfloat162float(p[i]);
  }
  __device__ static float masked(float v, float m) {
    return __bfloat162float(__float2bfloat16_rn(__fmul_rn(v, m)));
  }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  __device__ static void load4(const __nv_bfloat16* p, float* o) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
    o[0] = __low2float(a); o[1] = __high2float(a);
    o[2] = __low2float(b); o[3] = __high2float(b);
  }
};

// global index of local index p (0..7) of set S(X): X is passed as 4X
__device__ __forceinline__ int set_idx(int x4, int p) {
  return p < 4 ? x4 + p : 64 + x4 + (p - 4);
}

// the rhs (and, on warps 0 and 1, diagonal) index of thread c: blocks
// [32, 64) and [64, 96) swapped, so threads 0..63 hold the diagonal
// elements of S(0..7) = {0..31} u {64..95}
__device__ __forceinline__ int rhs_idx(int c) {
  return c < 32 || c >= 96 ? c : (c < 64 ? c + 32 : c - 32);
}

// ---------------------------------------------------------------------------
// K <= 128: persistent blocks of two row groups, a cp.async ring
// ---------------------------------------------------------------------------

// One step t for a thread: 2 float4 loads of S(xa) into a, 2 of S(xb)
// into b.  Warps 0 and 1 (ONE) own tiles S(I) x S(J) and a diagonal
// element each.  Warps 2 and 3 (TWO) hold 4 pair lanes each, whose a is
// S(d) and b is S(15 - d): their products below the local diagonal
// (p > q) take a x a, those on and above it b x b.  A select per operand
// gives every lane of the warp the same FMA instructions.
// A thread's operands of one step t
struct Ops {
  float a[8], b[8];   // v over S(xa), v over S(xb)
  float vk, mk, val;  // v at the rhs index, mask, val
};

template <typename Tin>
__device__ __forceinline__ void load_ops(const Tin* __restrict__ row,
                                         const float* __restrict__ vs,
                                         const float* __restrict__ ms,
                                         int tt, int xa, int xb, int rk,
                                         Ops& o) {
  In<Tin>::load4(row + xa, o.a);
  In<Tin>::load4(row + 64 + xa, o.a + 4);
  In<Tin>::load4(row + xb, o.b);
  In<Tin>::load4(row + 64 + xb, o.b + 4);
  o.vk = In<Tin>::get(row, rk);
  o.mk = ms[tt];
  o.val = vs[tt];
}

// The FMAs of one step.  Warps 0 and 1 (ONE) own tiles S(I) x S(J) and
// a diagonal element each.  Warps 2 and 3 (TWO) hold 4 pair lanes each,
// whose a is S(d) and b is S(15 - d): their products below the local
// diagonal (p > q) take a x a, those on and above it b x b.  A select
// per operand gives every lane of the warp the same FMA instructions.
template <typename Tin, bool TWO>
__device__ __forceinline__ void fma_step(const Ops& o, bool pair,
                                         float (&acc)[8][8], float& dg,
                                         float& racc) {
  const float m = In<Tin>::round(o.mk);
  const float w = In<Tin>::round(__fmul_rn(o.val, o.mk));
  float am[8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
    am[p] = In<Tin>::masked(o.a[p], m);
  if (!TWO) {
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[p][q] = fmaf(am[p], o.b[q], acc[p][q]);
  } else {
    float b1[8], a2[8];
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      b1[p] = pair ? o.a[p] : o.b[p];
      a2[p] = pair ? o.b[p] : o.a[p];
      a2[p] = In<Tin>::masked(a2[p], m);
    }
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int q = 0; q < 8; ++q)
        acc[p][q] = p > q ? fmaf(am[p], b1[q], acc[p][q])
                          : fmaf(a2[p], o.b[q], acc[p][q]);
  }
  if (!TWO) dg = fmaf(In<Tin>::masked(o.vk, m), o.vk, dg);
  racc = fmaf(o.vk, w, racc);
}

// The CH steps of a stage
template <typename Tin, bool TWO>
__device__ __forceinline__ void run_stage(const Tin* __restrict__ rows,
                                          const float* __restrict__ vs,
                                          const float* __restrict__ ms,
                                          int xa, int xb, bool pair, int rk,
                                          float (&acc)[8][8], float& dg,
                                          float& racc) {
#pragma unroll UNROLL
  for (int tt = 0; tt < CH; ++tt) {
    Ops o;
    load_ops(rows + tt * TILE, vs, ms, tt, xa, xb, rk, o);
    fma_step<Tin, TWO>(o, pair, acc, dg, racc);
  }
}

// x = g * alpha, then acc + x, then x + lam at place (i, j).  An absent
// alpha, acc or lam is 1, 0 or 0: g is never -0 (its fmaf chain starts
// at +0 and an exact zero sum rounds to +0), so x * 1, 0 + x and x + 0
// are x to the bit and one program serves every entry.
struct Epi {
  float alpha;
  const float* acc;   // the row's (K, K), or null
  const float* lam;   // (K, ls), or null
  int K, ls;
  __device__ __forceinline__ float one(float g, float a, float l) const {
    return __fadd_rn(__fadd_rn(a, __fmul_rn(g, alpha)), l);
  }
  __device__ __forceinline__ float operator()(float g, int i, int j) const {
    return one(g, acc ? acc[i * K + j] : 0.f, lam ? lam[i * ls + j] : 0.f);
  }
  // places (i, j..j+3), float4-aligned in acc and lam
  __device__ __forceinline__ float4 vec4(float4 g, int i, int j) const {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), l = a;
    if (acc) a = *reinterpret_cast<const float4*>(acc + i * K + j);
    if (lam) l = *reinterpret_cast<const float4*>(lam + i * ls + j);
    return make_float4(one(g.x, a.x, l.x), one(g.y, a.y, l.y),
                       one(g.z, a.z, l.z), one(g.w, a.w, l.w));
  }
};

// shared-memory row stride of lam: float4-aligned rows, 4 floats of
// padding so that a warp's float4 reads down a column (the mirror's
// places) fall on every bank
__host__ __device__ __forceinline__ int64_t out_stride(int64_t K) {
  return (K + 3) / 4 * 4 + 4;
}

__host__ __device__ __forceinline__ int64_t out_floats(int64_t K) {
  return (K * out_stride(K) + 31) / 32 * 32;
}

template <typename Tin>
__host__ __device__ __forceinline__ size_t stage_bytes() {
  return (size_t)CH * TILE * sizeof(Tin) + 2 * CH * 4;   // rows, val, mask
}

template <typename Tin>
__global__ void __launch_bounds__(THREADS, 1) gram_rows_kernel(Params P) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int64_t K = P.K, KK = K * K, T = P.T, LS = out_stride(K);
  constexpr size_t ROWS_B = (size_t)CH * TILE * sizeof(Tin);
  // lam (rows of LS floats), then each group's ring
  float* lam_s = reinterpret_cast<float*>(smem);
  const int g = threadIdx.x / GROUP_THREADS;
  unsigned char* ring = reinterpret_cast<unsigned char*>(
                            lam_s + (P.lam ? out_floats(K) : 0)) +
                        g * STAGES * stage_bytes<Tin>();
  if (P.lam)
    for (int64_t e = threadIdx.x; e < KK; e += THREADS)
      lam_s[e / K * LS + e % K] = P.lam[e];
  __syncthreads();
  const int tid = threadIdx.x % GROUP_THREADS, warp = tid / 32,
            lane = tid % 32;
  auto group_sync = [&]() {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + g), "n"(GROUP_THREADS)
                 : "memory");
  };
  // this group's rows: G, G + GROUPS * gridDim.x, ... from
  // G = GROUPS * blockIdx.x + g
  const int64_t first = (int64_t)blockIdx.x * GROUPS + g;
  const int64_t stride = (int64_t)gridDim.x * GROUPS;

  // the group's chunks: each of its rows in ceil(T / CH) chunks of CH
  // steps (one of zeros when T = 0), in order.  A cursor walks them.
  const int64_t nch = T > 0 ? (T + CH - 1) / CH : 1;
  struct Cursor {
    int64_t row, ch;
  };
  auto advance = [&](Cursor& x) {
    if (++x.ch == nch) {
      x.ch = 0;
      x.row += stride;
    }
  };
  const Tin* src = reinterpret_cast<const Tin*>(P.src);
  const uint32_t row_bytes = (uint32_t)(K * sizeof(Tin));
  // a thread copies step ctt of a chunk: pieces cpc, cpc + CP, ...
  constexpr int CP = GROUP_THREADS / CH;
  const int ctt = tid / CP, cpc = tid % CP;

  auto raw_idx = [&](const Cursor& x) -> int {   // chunks ahead, raw
    const int64_t t = x.ch * CH + ctt;
    if (x.row >= P.R || !P.idx || t >= T) return 0;
    return __ldg(P.idx + x.row * T + t);
  };
  auto issue = [&](const Cursor& x, int stage, int ri) {
    if (x.row < P.R) {
      const int64_t t0 = x.ch * CH, t = t0 + ctt;
      unsigned char* base = ring + stage * stage_bytes<Tin>();
      int64_t sr = -1;   // source row, -1: zeros
      if (t < T) {
        if (!P.idx)
          sr = x.row * T + t;
        else if (ri >= 0 && ri < P.n_src)
          sr = ri;
      }
      unsigned char* d = base + (size_t)ctt * TILE * sizeof(Tin);
      if (P.copy16) {
        const unsigned char* gs = reinterpret_cast<const unsigned char*>(src);
        for (uint32_t k = cpc; k < row_bytes / 16; k += CP) {
          if (sr >= 0)
            cp_async16(d + k * 16, gs + sr * row_bytes + k * 16);
          else
            *reinterpret_cast<float4*>(d + k * 16) =
                make_float4(0.f, 0.f, 0.f, 0.f);
        }
      } else {
        Tin* dt = reinterpret_cast<Tin*>(d);
        for (int64_t k = cpc; k < K; k += CP)
          dt[k] = sr >= 0 ? src[sr * K + k] : Tin(0.f);
      }
      if (tid < 2 * CH) {   // val (tid < CH) and mask of the CH steps
        const int64_t tu = t0 + tid % CH;
        const float* gs = tid < CH ? P.val : P.mask;
        if (tu < T)
          cp_async4(base + ROWS_B + tid * 4, gs + x.row * T + tu);
        else
          *reinterpret_cast<float*>(base + ROWS_B + tid * 4) = 0.f;
      }
    }
    cp_async_commit();
  };

  // the ring's first STAGES - 1 chunks; idx read two chunks ahead
  Cursor cc = {first, 0}, ic = cc;
  for (int k = 0; k < STAGES - 1; ++k) {
    issue(ic, k, raw_idx(ic));
    advance(ic);
  }
  Cursor pc = ic;
  int ri_a = raw_idx(pc);
  advance(pc);
  int ri_b = raw_idx(pc);
  advance(pc);
  int cs = 0, is = STAGES - 1;   // compute and issue stages

  // roles: rw 0 and 1 are ONE warps, 2 and 3 TWO warps; odd groups swap
  // them, so the SM's sub-partitions (warp % 4) each run both kinds
  const int rw = warp ^ ((g & 1) << 1), rt = rw * 32 + lane;
  const bool two = rw >= 2;
  const bool pair = two && lane >= 28;
  const int dd = (rw == 2 ? 0 : 4) + lane - 28;   // a pair lane's tile
  int xa, xb;   // 4 * the set ids of a and b
  if (!two) {
    const int I = 8 + 4 * rw + lane / 8, J = lane % 8;
    xa = 4 * I;
    xb = 4 * J;
  } else if (!pair) {
    int n = lane, I = 1;
    while (n >= I) {
      n -= I;
      ++I;
    }
    const int off = rw == 2 ? 0 : 8;
    xa = 4 * (I + off);
    xb = 4 * (n + off);
  } else {
    xa = 4 * dd;          // strictly below tile dd's diagonal
    xb = 4 * (15 - dd);   // on and above tile 15 - dd's diagonal
  }
  const int rk = rhs_idx(rt);
  const float alpha = P.alpha ? __ldg(P.alpha) : 1.f;   // absent: 1

  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
  float dg = 0.f, racc = 0.f;
  for (; cc.row < P.R; advance(cc)) {
    cp_async_wait<STAGES - 2>();   // this chunk has landed (this thread's)
    group_sync();                  // everyone's; the last one is done
    issue(ic, is, ri_a);           // into the last chunk's stage
    advance(ic);
    is = is + 1 == STAGES ? 0 : is + 1;
    ri_a = ri_b;
    ri_b = raw_idx(pc);
    advance(pc);

    unsigned char* base = ring + cs * stage_bytes<Tin>();
    cs = cs + 1 == STAGES ? 0 : cs + 1;
    const Tin* st = reinterpret_cast<const Tin*>(base);
    const float* vs = reinterpret_cast<const float*>(base + ROWS_B);
    const float* ms = vs + CH;
    if (two)
      run_stage<Tin, true>(st, vs, ms, xa, xb, pair, rk, acc, dg, racc);
    else
      run_stage<Tin, false>(st, vs, ms, xa, xb, pair, rk, acc, dg, racc);
    if (cc.ch != nch - 1) continue;

    // ---- the row's last chunk: every place (i, j) gets
    // (acc + g * alpha) + lam, stored straight from the registers; the
    // stores drain while the group's next row runs
    const int64_t row = cc.row;
    float* og = P.out_g + row * KK;
    const int k32 = (int)K;   // offsets within a row
    const Epi epi = {alpha, P.acc_g ? P.acc_g + row * KK : nullptr,
                     P.lam ? lam_s : nullptr, k32, (int)LS};
    float* scratch = reinterpret_cast<float*>(base);   // 8 x 64
    group_sync();   // every thread is done with this chunk's stage
    if (pair) {
      // the two triangles go through scratch (phase 2 below)
#pragma unroll
      for (int pp = 0; pp < 8; ++pp)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float4*>(scratch + dd * 64 + pp * 8 + 4 * h) =
              make_float4(acc[pp][4 * h], acc[pp][4 * h + 1],
                          acc[pp][4 * h + 2], acc[pp][4 * h + 3]);
    } else if (P.vec) {
      // a tile S(I) x S(J), I > J, at its places and mirrored, float4s
#pragma unroll
      for (int pp = 0; pp < 8; ++pp)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = set_idx(xa, pp), j = (h ? 64 : 0) + xb;
          if (i < K && j < K)
            *reinterpret_cast<float4*>(og + i * k32 + j) = epi.vec4(
                make_float4(acc[pp][4 * h], acc[pp][4 * h + 1],
                            acc[pp][4 * h + 2], acc[pp][4 * h + 3]),
                i, j);
        }
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = set_idx(xb, q), i = (h ? 64 : 0) + xa;
          if (i < K && j < K)
            *reinterpret_cast<float4*>(og + j * k32 + i) = epi.vec4(
                make_float4(acc[4 * h][q], acc[4 * h + 1][q],
                            acc[4 * h + 2][q], acc[4 * h + 3][q]),
                j, i);
        }
    } else {
#pragma unroll
      for (int pp = 0; pp < 8; ++pp)
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int i = set_idx(xa, pp), j = set_idx(xb, q);
          if (i < K && j < K) {
            og[i * k32 + j] = epi(acc[pp][q], i, j);
            og[j * k32 + i] = epi(acc[pp][q], j, i);
          }
        }
    }
    if (!two && rk < K) og[rk * k32 + rk] = epi(dg, rk, rk);
    if (rk < K) {
      float x = __fmul_rn(racc, alpha);
      if (P.acc_r) x = __fadd_rn(P.acc_r[row * K + rk], x);
      P.out_r[row * K + rk] = x;
    }
    group_sync();
    {
      // phase 2: the pair lanes' 8 x 64 elements, 4 a thread
      const int pr = tid / 16, e0 = (tid % 16) * 4;
      const float4 g4 =
          *reinterpret_cast<const float4*>(scratch + pr * 64 + e0);
      const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u, pp = e / 8, q = e % 8;
        const int x4 = 4 * (pp > q ? pr : 15 - pr);
        const int i = set_idx(x4, pp), j = set_idx(x4, q);
        if (i < K && j < K) {
          og[i * k32 + j] = epi(gv[u], i, j);
          if (i != j) og[j * k32 + i] = epi(gv[u], j, i);   // acc may be og
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
    dg = racc = 0.f;
  }
}

// ---------------------------------------------------------------------------
// K > 128: a block a row and 128 x 128 output tile (the first design)
// ---------------------------------------------------------------------------

constexpr int HALF = TILE / 2;
constexpr int TCH = 16;          // t steps a shared-memory chunk
constexpr int TTHREADS = 256;    // 16 x 16 threads, 8 x 8 outputs each
constexpr int PER = TCH * TILE / TTHREADS;

template <typename Tin>
__device__ __forceinline__ const Tin* row_ptr(const Params& P, int64_t row,
                                              int64_t t) {
  const Tin* src = reinterpret_cast<const Tin*>(P.src);
  if (t >= P.T) return nullptr;
  const int64_t e = row * P.T + t;
  if (!P.idx) return src + e * P.K;
  const int64_t s = __ldg(P.idx + e);
  return (s >= 0 && s < P.n_src) ? src + s * P.K : nullptr;
}

// DIAG: blockIdx.y = ti = tj, the upper-right quadrant mirrored.
// Otherwise blockIdx.y enumerates the tile pairs ti > tj, mirrored.
template <typename Tin, bool DIAG>
__global__ void __launch_bounds__(TTHREADS, 2) gram_tiled_kernel(Params P) {
  __shared__ __align__(16) float As[TCH][TILE];  // v * mask, i-range
  __shared__ __align__(16) float Bs[TCH][TILE];  // v, j-range
  __shared__ float Ws[TCH];                      // val * mask

  const int64_t row = blockIdx.x, T = P.T, K = P.K;
  int ti, tj;
  if (DIAG) {
    ti = tj = blockIdx.y;
  } else {
    int p = blockIdx.y;
    ti = 1;
    while (p >= ti) {
      p -= ti;
      ++ti;
    }
    tj = p;
  }
  const int64_t i0 = (int64_t)ti * TILE, j0 = (int64_t)tj * TILE;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;
  float racc = 0.f;

  for (int64_t t0 = 0; t0 < T; t0 += TCH) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = tid + k * TTHREADS, tt = e / TILE, kk = e % TILE;
      const int64_t t = t0 + tt;
      const Tin* v = row_ptr<Tin>(P, row, t);
      const float m = t < T ? In<Tin>::round(P.mask[row * T + t]) : 0.f;
      const float a = v && i0 + kk < K ? In<Tin>::get(v, i0 + kk) : 0.f;
      const float b = v && j0 + kk < K ? In<Tin>::get(v, j0 + kk) : 0.f;
      As[tt][kk] = In<Tin>::masked(a, m);
      Bs[tt][kk] = DIAG ? a : b;
    }
    if (DIAG && tid < TCH) {
      const int64_t t = t0 + tid;
      Ws[tid] = t < T ? In<Tin>::round(__fmul_rn(P.val[row * T + t],
                                                 P.mask[row * T + t]))
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int tt = 0; tt < TCH; ++tt) {
      float a[8], b[8];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        a[u] = As[tt][ty * 4 + u];
        a[4 + u] = As[tt][HALF + ty * 4 + u];
        b[u] = Bs[tt][tx * 4 + u];
        b[4 + u] = Bs[tt][HALF + tx * 4 + u];
      }
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (!DIAG || p >= 4 || q < 4)   // skip (a0, b1) on the diagonal
            acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
    }
    if (DIAG && tid < TILE) {
#pragma unroll
      for (int tt = 0; tt < TCH; ++tt) racc = fmaf(Bs[tt][tid], Ws[tt], racc);
    }
    __syncthreads();
  }

  const Epi epi = {P.alpha ? __ldg(P.alpha) : 1.f,
                   P.acc_g ? P.acc_g + row * K * K : nullptr, P.lam, (int)K,
                   (int)K};
  float* out = P.out_g + row * K * K;
  // computed quadrants at their own place: rows gi, columns gj
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int64_t gi = i0 + (p < 4 ? ty * 4 + p : HALF + ty * 4 + p - 4);
    if (gi >= K) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (DIAG && p < 4 && h == 1) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int64_t gj = j0 + h * HALF + tx * 4 + q;
        if (gj < K) out[gi * K + gj] = epi(acc[p][h * 4 + q], gi, gj);
      }
    }
  }
  // mirrored: on the diagonal only the (a1, b0) quadrant, off it all
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    if (DIAG && q >= 4) continue;
    const int64_t gj = j0 + (q < 4 ? tx * 4 + q : HALF + tx * 4 + q - 4);
    if (gj >= K) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (DIAG && h == 0) continue;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int64_t gi = i0 + h * HALF + ty * 4 + p;
        if (gi < K) out[gj * K + gi] = epi(acc[h * 4 + p][q], gj, gi);
      }
    }
  }
  if (DIAG && tid < TILE && i0 + tid < K) {
    const int64_t k = i0 + tid;
    float x = __fmul_rn(racc, epi.alpha);
    if (P.acc_r) x = __fadd_rn(P.acc_r[row * K + k], x);
    P.out_r[row * K + k] = x;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

bool aligned16(const void* p) { return p == nullptr || ((uintptr_t)p & 15) == 0; }

template <typename Tin>
size_t rows_smem(const Params& P) {
  return 4 * (P.lam ? out_floats(P.K) : 0) +
         GROUPS * STAGES * stage_bytes<Tin>();
}

template <typename Tin>
cudaError_t launch(Params P, cudaStream_t stream) {
  if (P.R <= 0 || P.K <= 0) return cudaGetLastError();
  if (P.K <= TILE) {
    const size_t in_size = sizeof(Tin);
    P.copy16 = P.copy16 && (P.K * in_size) % 16 == 0 && aligned16(P.src);
    P.vec = P.K % 4 == 0 && aligned16(P.acc_g) && aligned16(P.out_g);
    const size_t smem = rows_smem<Tin>(P);
    cudaError_t err = cudaFuncSetAttribute(
        gram_rows_kernel<Tin>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    int dev = 0, nsm = 0, occ = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, gram_rows_kernel<Tin>, THREADS, smem);
    if (err != cudaSuccess) return err;
    if (occ < 1) return cudaErrorInvalidConfiguration;
    const int64_t need = (P.R + GROUPS - 1) / GROUPS;
    const int64_t grid = need < (int64_t)nsm * occ ? need : (int64_t)nsm * occ;
    gram_rows_kernel<Tin><<<(unsigned)grid, THREADS, smem, stream>>>(P);
    return cudaGetLastError();
  }
  const int64_t n = (P.K + TILE - 1) / TILE;
  if (P.R > 0x7fffffffLL || n * (n - 1) / 2 > 65535)
    return cudaErrorInvalidValue;
  gram_tiled_kernel<Tin, true>
      <<<dim3((unsigned)P.R, (unsigned)n), TTHREADS, 0, stream>>>(P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gram_tiled_kernel<Tin, false>
      <<<dim3((unsigned)P.R, (unsigned)(n * (n - 1) / 2)), TTHREADS, 0,
         stream>>>(P);
  return cudaGetLastError();
}

Params pregathered(const void* vg, const void* val, const void* mask,
                   void* gram, void* rhs, int64_t R, int64_t T, int64_t K,
                   int vec) {
  Params P = {};
  P.src = vg;
  P.val = (const float*)val;
  P.mask = (const float*)mask;
  P.out_g = (float*)gram;
  P.out_r = (float*)rhs;
  P.R = R;
  P.T = T;
  P.K = K;
  P.n_src = R * T;
  P.copy16 = vec;
  return P;
}

}  // namespace

// Pre-gathered entry: vg (R, T, K) fp32, val (R, T), mask (R, T) fp32,
// contiguous -> gram (R, K, K), rhs (R, K) fp32.  vec != 0 promises
// K % 4 == 0 and 16-byte aligned vg and gram.  Returns the
// cudaError_t of the launch.
extern "C" int gram_f32(const void* vg, const void* val, const void* mask,
                        void* gram, void* rhs, int64_t R, int64_t T,
                        int64_t K, int vec, void* stream) {
  return (int)launch<float>(
      pregathered(vg, val, mask, gram, rhs, R, T, K, vec),
      (cudaStream_t)stream);
}

// The same with bf16 operand rows vg (R, T, K); val and mask fp32 (the
// wrapper widens bf16 ones exactly).  vec != 0 promises K % 8 == 0 and
// 16-byte aligned vg and gram.
extern "C" int gram_bf16(const void* vg, const void* val, const void* mask,
                         void* gram, void* rhs, int64_t R, int64_t T,
                         int64_t K, int vec, void* stream) {
  return (int)launch<__nv_bfloat16>(
      pregathered(vg, val, mask, gram, rhs, R, T, K, vec),
      (cudaStream_t)stream);
}

namespace {

Params gathered(const void* fixed, const void* idx, const void* val,
                const void* mask, const void* alpha, const void* acc_g,
                const void* acc_r, const void* lam, void* out_g, void* out_r,
                int64_t R, int64_t T, int64_t K, int64_t n_fixed) {
  Params P = {};
  P.src = fixed;
  P.idx = (const int*)idx;
  P.val = (const float*)val;
  P.mask = (const float*)mask;
  P.alpha = (const float*)alpha;
  P.acc_g = (const float*)acc_g;
  P.acc_r = (const float*)acc_r;
  P.lam = (const float*)lam;
  P.out_g = (float*)out_g;
  P.out_r = (float*)out_r;
  P.R = R;
  P.T = T;
  P.K = K;
  P.n_src = n_fixed;
  P.copy16 = 1;
  return P;
}

}  // namespace

// Gathered entry: fixed (n_fixed, K) fp32, idx (R, T) int32, val and
// mask (R, T) fp32, alpha a 0-d fp32 on the device, acc_g (R, K, K) and
// acc_r (R, K) or null, lam (K, K) or null, all contiguous ->
// out_g (R, K, K) = (alpha * g + acc_g) + lam and out_r (R, K) =
// alpha * b + acc_r; out_g and out_r may be acc_g and acc_r.
extern "C" int gram_gathered_f32(const void* fixed, const void* idx,
                                 const void* val, const void* mask,
                                 const void* alpha, const void* acc_g,
                                 const void* acc_r, const void* lam,
                                 void* out_g, void* out_r, int64_t R,
                                 int64_t T, int64_t K, int64_t n_fixed,
                                 void* stream) {
  return (int)launch<float>(gathered(fixed, idx, val, mask, alpha, acc_g,
                                     acc_r, lam, out_g, out_r, R, T, K,
                                     n_fixed),
                            (cudaStream_t)stream);
}

// The same with a bf16 fixed factor (n_fixed, K); val, mask, alpha, acc,
// lam and the outputs fp32.
extern "C" int gram_gathered_bf16(const void* fixed, const void* idx,
                                  const void* val, const void* mask,
                                  const void* alpha, const void* acc_g,
                                  const void* acc_r, const void* lam,
                                  void* out_g, void* out_r, int64_t R,
                                  int64_t T, int64_t K, int64_t n_fixed,
                                  void* stream) {
  return (int)launch<__nv_bfloat16>(
      gathered(fixed, idx, val, mask, alpha, acc_g, acc_r, lam, out_g,
               out_r, R, T, K, n_fixed),
      (cudaStream_t)stream);
}
