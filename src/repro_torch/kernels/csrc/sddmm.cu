// SDDMM, fp32, for Hopper (sm_90a), with three entries:
//
//   sddmm_f32:          pred[e]   = sum_k ug[e,k] * vg[e,k]
//   sddmm_gathered_f32: pred[e]   = sum_k U[i[e],k] * V[j[e],k]
//   sddmm_padded_f32:   pred[r,t] = sum_k U[r,k] * V[idx[r,t],k]
//
// Replaces the Pallas-TPU kernel src/repro/kernels/sddmm.py
// (sddmm_pallas / _sddmm_kernel, pallas_call at line 53), which tiles
// (E, K) into (512, 128) VMEM blocks and accumulates over the K axis.
//
// The pre-gathered entry (sddmm_f32).  Each entry reads 2*K*4 bytes and
// does 2*K operations, a quarter of an operation per byte, so the least
// time is the bytes over 3.35 TB/s.  One warp owns one entry, each lane
// loads a float4 of both operands per step (one 512-byte line per
// operand for K = 128), keeps a fp32 partial sum, and the warp adds the
// 32 partials with shuffles in a fixed order.  A grid-stride loop
// covers any E, and every offset is 64-bit.
//
// The gathered entries (sddmm_gathered_f32, and sddmm_padded_f32 for a
// padded layout whose row r of U serves the T slots idx[r]) read the
// rows U[i[e]] and V[j[e]] in their loads, so the sweep makes no (E, K)
// copies of them.  What bounds them: the DRAM bound counts each row of
// U and V once, with the indices and the output (at the sweep's 131,072
// x 128 and 8,192 x 128 factors, 8,388,608 entries: 172 MB, 0.05 ms).
// No design reaches it at 64 entries per 8,192 columns: the practical
// floor is the random side's row, read from L2 once per entry (K * 4
// bytes an entry), with the other side's row read once per run of equal
// i.  Runs come by construction in a padded layout (T slots a row) and
// in a COO sorted by row, as chip_smoke.py's slice is; from_coo
// (core/sparse.py) keeps the caller's order, and a COO in random order
// has no runs: each entry then reads both of its rows, as the first
// design did.
//
// How the design answers it.  One wave of warps (as many as the SMs
// hold at once) covers E, each warp a contiguous range of tiles of 32
// entries.  For a tile it reads the 32 i and j in one coalesced load
// each (the next tile's are in flight meanwhile) and broadcasts them by
// shuffle; it loads a row of U only where i differs from the previous
// entry's, and keeps that row in registers from one tile to the next,
// so a run is read once (once more where it crosses into another
// warp's range; for K wider than one block of columns, 128 for float4
// steps and 32 for floats, once per tile and block).  It keeps the rows
// of the next D entries in flight in registers (D = 6; 5, 7 and 8 were
// slower at K = 128) while it runs the FMAs of the current one.  The 32
// entries' partials are reduced together, 31 shuffles for the tile
// instead of 5 an entry, and lane l ends with entry l's sum: one
// coalesced store of 32 results.
//
// Bytes through the caches an entry, as modelled (no counter reads
// them): K * 4 for V's row, K * 4 / run length for U's (plus at most one
// row a warp of the wave, where a run crosses into the next warp's
// range), and 12 (COO) or 8 (padded slots) for the indices and the
// output.  At the sweeps' shapes (K = 128) that is 532.0 bytes at the
// observed entries (runs of 64), 528.0 on probit's padded rows (runs of
// 64), 520.4 on its padded columns (runs of 1,144) and 1,036.0 with
// the observed entries in random order.  Those modelled bytes over the
// measured time (chip_smoke.py, one run on an H100 80GB HBM3 at 700 W):
// 7.3, 7.0, 5.7 and 7.4 TB/s through the caches, at 0.615, 0.635,
// 0.857 and 1.174 ms.  The columns' random side, the 67 MB compound
// factor, does not fit the 50 MB L2; in random order U's rows are the
// compound factor's too.
//
// The same bits as the first design (one warp an entry; kept in
// scripts_dev/sddmm_v1.cu) and as sddmm_f32 on the index_selected rows:
// lane l runs the same fmaf chain over the same columns in the same
// ascending order (a float4 at k = 4l, 4l + 128, ... for K % 4 == 0,
// else k = l, l + 32, ...) from 0.0f, and the tile's reduction adds
// the same 32 partials in the same binary tree as the xor-shuffle
// butterfly off = 16, 8, 4, 2, 1 (at each level the pairs it adds are
// the butterfly's pairs; fp32 addition is commutative).  Wide K is
// walked in blocks of 32 steps, the partial carried from one block to
// the next, so the order does not change.  A row index outside [0, n)
// gives the entry 0.0f, as the first design did.  The wrappers refuse U
// or V off a 16-byte boundary (one float4 load path).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
sddmm_kernel(const float* __restrict__ ug, const float* __restrict__ vg,
             float* __restrict__ out, int64_t E, int64_t K, int vec) {
  const int lane = threadIdx.x % 32;
  const int64_t first = (int64_t)blockIdx.x * WARPS + threadIdx.x / 32;
  const int64_t stride = (int64_t)gridDim.x * WARPS;
  for (int64_t e = first; e < E; e += stride) {
    const float* u = ug + e * K;
    const float* v = vg + e * K;
    float s = 0.f;
    if (vec) {
      for (int64_t k = lane * 4; k < K; k += 128) {
        const float4 a = *reinterpret_cast<const float4*>(u + k);
        const float4 b = *reinterpret_cast<const float4*>(v + k);
        s = fmaf(a.x, b.x, s);
        s = fmaf(a.y, b.y, s);
        s = fmaf(a.z, b.z, s);
        s = fmaf(a.w, b.w, s);
      }
    } else {
      for (int64_t k = lane; k < K; k += 32) s = fmaf(u[k], v[k], s);
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      s += __shfl_xor_sync(FULL, s, off);
    if (lane == 0) out[e] = s;
  }
}

// What a lane loads a step: a float4 (K % 4 == 0) or one float, and its
// fmaf chain over it, in the first design's order.
template <bool BY4>
struct Step;

template <>
struct Step<true> {
  using T = float4;
  static constexpr int W = 4;
  static __device__ __forceinline__ float4 load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ float4 zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ float fma(float4 a, float4 b, float s) {
    s = fmaf(a.x, b.x, s);
    s = fmaf(a.y, b.y, s);
    s = fmaf(a.z, b.z, s);
    return fmaf(a.w, b.w, s);
  }
};

template <>
struct Step<false> {
  using T = float;
  static constexpr int W = 1;
  static __device__ __forceinline__ float load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float zero() { return 0.f; }
  static __device__ __forceinline__ float fma(float a, float b, float s) {
    return fmaf(a, b, s);
  }
};

// One launch's entries: entry e pairs row i[e] of U (row e / T when i
// is null: the slots of a padded layout) with row j[e] of V.
struct Pairs {
  const float* U;
  const float* V;
  const int* i;
  const int* j;
  float* out;
  int64_t E, T, K, n_u, n_v;
};

// The loads of tile entry t (broadcast from lane t) at this lane's
// column k into ring slot (ub, vb): U's row only where the entry starts
// a run (bit t of load_u), V's where both indices are in range (bit t
// of ok).
template <bool BY4>
__device__ __forceinline__ void fetch(const Pairs& p, int64_t k, int r, int c,
                                      int t, unsigned load_u, unsigned ok,
                                      typename Step<BY4>::T& ub,
                                      typename Step<BY4>::T& vb) {
  using S = Step<BY4>;
  const int rt = __shfl_sync(FULL, r, t);
  const int ct = __shfl_sync(FULL, c, t);
  if (k < p.K) {
    if ((load_u >> t) & 1u) ub = S::load(p.U + (int64_t)rt * p.K + k);
    if ((ok >> t) & 1u) vb = S::load(p.V + (int64_t)ct * p.K + k);
  }
}

// The tile's indices: entry e's rows (r, c), -1 past the end.
__device__ __forceinline__ void tile_rows(const Pairs& p, int64_t tile,
                                          int lane, int& r, int& c) {
  const int64_t e = tile * 32 + lane;
  r = c = -1;
  if (e < p.E) {
    r = p.i ? __ldg(p.i + e) : (int)(e / p.T);
    c = __ldg(p.j + e);
  }
}

// A warp walks a contiguous range of tiles of 32 entries (per_warp
// tiles; one wave of warps covers E).  A lane holds one step of a row
// (a float4 or a float) in a block of 32 * W columns; wider K takes
// several blocks, its partials carried from one block to the next.  D:
// the entries whose rows are in flight.  When K fits one block, U's row
// stays in registers from one tile to the next, so a run that crosses
// tiles is read once.
template <bool BY4>
__global__ void __launch_bounds__(THREADS)
sddmm_tiles_kernel(const Pairs p, const int64_t per_warp) {
  using S = Step<BY4>;
  using T = typename S::T;
  constexpr int D = 6;
  constexpr int64_t BLOCK = 32 * S::W;   // columns a block of steps
  const int lane = threadIdx.x % 32;
  const int64_t tiles = (p.E + 31) / 32;
  const int64_t first = ((int64_t)blockIdx.x * WARPS + threadIdx.x / 32)
                        * per_warp;
  const int64_t end = first + per_warp < tiles ? first + per_warp : tiles;
  const bool carry = p.K <= BLOCK;
  T ub[D], vb[D], u = S::zero();
#pragma unroll
  for (int s = 0; s < D; ++s) ub[s] = vb[s] = S::zero();
  int r, c, r_tail = -1;
  if (first < end) tile_rows(p, first, lane, r, c);
  for (int64_t tile = first; tile < end; ++tile) {
    int r_next = -1, c_next = -1;   // the next tile's indices in flight
    if (tile + 1 < end) tile_rows(p, tile + 1, lane, r_next, c_next);
    const bool r_in = r >= 0 && r < p.n_u;
    const bool in = r_in && c >= 0 && c < p.n_v;
    const int r_before = __shfl_up_sync(FULL, r, 1);
    const bool starts = lane ? r != r_before
                             : !carry || tile == first || r != r_tail;
    const unsigned ok = __ballot_sync(FULL, in);
    const unsigned fresh = __ballot_sync(FULL, starts);
    const unsigned load_u = __ballot_sync(FULL, starts && r_in);

    float acc[32];
#pragma unroll
    for (int t = 0; t < 32; ++t) acc[t] = 0.f;
    for (int64_t kb = 0; kb < p.K; kb += BLOCK) {
      const int64_t k = kb + lane * S::W;
#pragma unroll
      for (int t = 0; t < D; ++t)
        fetch<BY4>(p, k, r, c, t, load_u, ok, ub[t], vb[t]);
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const int s = t % D;
        if ((fresh >> t) & 1u) u = ub[s];
        if (k < p.K) acc[t] = S::fma(u, vb[s], acc[t]);
        if (t + D < 32)
          fetch<BY4>(p, k, r, c, t + D, load_u, ok, ub[s], vb[s]);
      }
    }
    // the butterfly's tree for all 32 entries at once: at level off,
    // a lane keeps the half of its entries whose bit off matches its
    // own and adds its partner's partials of them.  Every loop over acc
    // has a constant trip count, so that it unrolls and acc stays in
    // registers (with t < off as the bound, acc went to local memory
    // and the kernel took 1.8x as long)
#pragma unroll
    for (int level = 0; level < 5; ++level) {
      const int off = 16 >> level;
      const bool upper = lane & off;
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        if (t < off) {
          const float mine = upper ? acc[t + off] : acc[t];
          const float theirs = upper ? acc[t] : acc[t + off];
          acc[t] = mine + __shfl_xor_sync(FULL, theirs, off);
        }
      }
    }
    const int64_t e = tile * 32 + lane;
    if (e < p.E) p.out[e] = in ? acc[0] : 0.f;
    r_tail = __shfl_sync(FULL, r, 31);
    r = r_next;
    c = c_next;
  }
}

int64_t grid_for(int64_t E) {
  int64_t blocks = (E + WARPS - 1) / WARPS;
  return blocks > 1048576 ? 1048576 : blocks;
}

// One wave of warps, each a contiguous range of tiles.
template <bool BY4>
void launch_tiles(const Pairs& p, cudaStream_t stream) {
  static const int64_t resident = [] {
    int dev = 0, sms = 0, blocks = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, sddmm_tiles_kernel<BY4>, THREADS, 0);
    return (int64_t)(sms > 0 ? sms : 1) * (blocks > 0 ? blocks : 1) * WARPS;
  }();
  const int64_t tiles = (p.E + 31) / 32;
  const int64_t per_warp = (tiles + resident - 1) / resident;
  const int64_t warps = (tiles + per_warp - 1) / per_warp;
  sddmm_tiles_kernel<BY4>
      <<<(unsigned)((warps + WARPS - 1) / WARPS), THREADS, 0, stream>>>(
          p, per_warp);
}

int launch(const Pairs& p, int by4, void* stream) {
  if (p.E <= 0) return (int)cudaGetLastError();
  if (by4)
    launch_tiles<true>(p, (cudaStream_t)stream);
  else
    launch_tiles<false>(p, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // namespace

// ug, vg (E, K) fp32, contiguous -> out (E,) fp32.
// vec != 0 promises K % 4 == 0 and 16-byte aligned ug and vg.
// Returns the cudaError_t of the launch.
extern "C" int sddmm_f32(const void* ug, const void* vg, void* out,
                         int64_t E, int64_t K, int vec, void* stream) {
  if (E <= 0) return (int)cudaGetLastError();
  sddmm_kernel<<<(unsigned)grid_for(E), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)ug, (const float*)vg, (float*)out, E, K, vec);
  return (int)cudaGetLastError();
}

// U (n_u, K), V (n_v, K) fp32, contiguous, 16-byte aligned; i, j (E,)
// int32 -> out (E,) fp32.  by4 != 0 promises K % 4 == 0 (the k order
// of sddmm_f32's vec path).  Returns the cudaError_t of the launch.
extern "C" int sddmm_gathered_f32(const void* U, const void* V,
                                  const void* i, const void* j, void* out,
                                  int64_t E, int64_t K, int64_t n_u,
                                  int64_t n_v, int by4, void* stream) {
  const Pairs p{(const float*)U, (const float*)V, (const int*)i,
                (const int*)j, (float*)out, E, 1, K, n_u, n_v};
  return launch(p, by4, stream);
}

// U (R, K), V (n_v, K) fp32, contiguous, 16-byte aligned; idx (R, T)
// int32 -> out (R, T) fp32, out[r, t] = U[r] . V[idx[r, t]]: the
// gathered entry with i = the slot's row.  by4 as above.
extern "C" int sddmm_padded_f32(const void* U, const void* V,
                                const void* idx, void* out, int64_t R,
                                int64_t T, int64_t K, int64_t n_v, int by4,
                                void* stream) {
  const Pairs p{(const float*)U, (const float*)V, nullptr,
                (const int*)idx, (float*)out, R * T, T, K, R, n_v};
  return launch(p, by4, stream);
}
