// SDDMM for Hopper (sm_90a), fp32 accumulation, with three entries, each
// for fp32 operands and for the bf16 ones of the reference's bf16_gather:
//
//   sddmm_f32, sddmm_bf16:          pred[e]   = sum_k ug[e,k] * vg[e,k]
//   sddmm_gathered_f32, _bf16:      pred[e]   = sum_k U[i[e],k] * V[j[e],k]
//   sddmm_padded_f32, _bf16, _mixed: pred[r,t] = sum_k U[r,k] * V[idx[r,t],k]
//
// (_mixed: fp32 U against bf16 V, probit's predictions in the bf16 sweep.)
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
// bf16 operands (the reference's ModelDef.bf16_gather; its sddmm_ref
// takes bf16 x bf16 with fp32 accumulation, and its probit einsum
// promotes a bf16 fixed factor against the fp32 u to fp32): the *_bf16
// entries read both operands in bf16, sddmm_padded_mixed reads u in fp32
// and the fixed rows in bf16.  A lane loads the same columns as in fp32
// (8 bytes of bf16 for a step of 4, or one element) and widens them
// exactly (a bf16 is the high half of its fp32), so each entry runs the
// fp32 kernel's float program on the widened values: the product of two
// bf16 values is exact in fp32 and the sum is the fp32 fmaf chain.
// Half the bytes of a row are read, and the same instructions run
// after the loads; what bounds the bf16 entries is what bounds the fp32
// ones, at half the row bytes.
//
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// An operand's element type, by kind: 0 fp32 x fp32, 1 bf16 x bf16,
// 2 fp32 u against bf16 rows (the kinds of the C entries below).
template <int KIND>
struct Kind;
template <>
struct Kind<0> {
  using U = float;
  using V = float;
};
template <>
struct Kind<1> {
  using U = __nv_bfloat16;
  using V = __nv_bfloat16;
};
template <>
struct Kind<2> {
  using U = float;
  using V = __nv_bfloat16;
};

// What a lane loads a step of one operand's row: 4 elements (a float4,
// or 8 bytes of bf16; K % 4 == 0) or one, kept raw in registers and
// widened exactly to fp32 where the FMAs read it.
template <bool BY4, typename E>
struct Step;

template <>
struct Step<true, float> {
  using Raw = float4;
  static constexpr int W = 4;
  static __device__ __forceinline__ float4 load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ float4 zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ float4 wide(float4 x) { return x; }
};

__device__ __forceinline__ float bf16_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

template <>
struct Step<true, __nv_bfloat16> {
  using Raw = uint2;
  static constexpr int W = 4;
  static __device__ __forceinline__ uint2 load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ uint2 zero() { return make_uint2(0, 0); }
  static __device__ __forceinline__ float4 wide(uint2 x) {
    return make_float4(bf16_lo(x.x), bf16_hi(x.x), bf16_lo(x.y),
                       bf16_hi(x.y));
  }
};

template <>
struct Step<false, float> {
  using Raw = float;
  static constexpr int W = 1;
  static __device__ __forceinline__ float load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float zero() { return 0.f; }
  static __device__ __forceinline__ float wide(float x) { return x; }
};

template <>
struct Step<false, __nv_bfloat16> {
  using Raw = unsigned short;
  static constexpr int W = 1;
  static __device__ __forceinline__ unsigned short load(
      const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ __forceinline__ unsigned short zero() { return 0; }
  static __device__ __forceinline__ float wide(unsigned short x) {
    return __uint_as_float((uint32_t)x << 16);
  }
};

// the fmaf chain over one step, in the first design's order
__device__ __forceinline__ float dot_step(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}
__device__ __forceinline__ float dot_step(float a, float b, float s) {
  return fmaf(a, b, s);
}

// The pre-gathered entries: one warp an entry.
template <typename E>
__global__ void __launch_bounds__(THREADS)
sddmm_kernel(const E* __restrict__ ug, const E* __restrict__ vg,
             float* __restrict__ out, int64_t n, int64_t K, int vec) {
  using S4 = Step<true, E>;
  using S1 = Step<false, E>;
  const int lane = threadIdx.x % 32;
  const int64_t first = (int64_t)blockIdx.x * WARPS + threadIdx.x / 32;
  const int64_t stride = (int64_t)gridDim.x * WARPS;
  for (int64_t e = first; e < n; e += stride) {
    const E* u = ug + e * K;
    const E* v = vg + e * K;
    float s = 0.f;
    if (vec) {
      for (int64_t k = lane * 4; k < K; k += 128)
        s = dot_step(S4::wide(S4::load(u + k)), S4::wide(S4::load(v + k)),
                     s);
    } else {
      for (int64_t k = lane; k < K; k += 32)
        s = fmaf(S1::wide(S1::load(u + k)), S1::wide(S1::load(v + k)), s);
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      s += __shfl_xor_sync(FULL, s, off);
    if (lane == 0) out[e] = s;
  }
}

// One launch's entries: entry e pairs row i[e] of U (row e / T when i
// is null: the slots of a padded layout) with row j[e] of V.
template <int KIND>
struct Pairs {
  const typename Kind<KIND>::U* U;
  const typename Kind<KIND>::V* V;
  const int* i;
  const int* j;
  float* out;
  int64_t E, T, K, n_u, n_v;
};

// The loads of tile entry t (broadcast from lane t) at this lane's
// column k into ring slot (ub, vb): U's row only where the entry starts
// a run (bit t of load_u), V's where both indices are in range (bit t
// of ok).
template <bool BY4, int KIND>
__device__ __forceinline__ void fetch(
    const Pairs<KIND>& p, int64_t k, int r, int c, int t, unsigned load_u,
    unsigned ok, typename Step<BY4, typename Kind<KIND>::U>::Raw& ub,
    typename Step<BY4, typename Kind<KIND>::V>::Raw& vb) {
  using SU = Step<BY4, typename Kind<KIND>::U>;
  using SV = Step<BY4, typename Kind<KIND>::V>;
  const int rt = __shfl_sync(FULL, r, t);
  const int ct = __shfl_sync(FULL, c, t);
  if (k < p.K) {
    if ((load_u >> t) & 1u) ub = SU::load(p.U + (int64_t)rt * p.K + k);
    if ((ok >> t) & 1u) vb = SV::load(p.V + (int64_t)ct * p.K + k);
  }
}

// The tile's indices: entry e's rows (r, c), -1 past the end.
template <int KIND>
__device__ __forceinline__ void tile_rows(const Pairs<KIND>& p, int64_t tile,
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
template <bool BY4, int KIND>
__global__ void __launch_bounds__(THREADS)
sddmm_tiles_kernel(const Pairs<KIND> p, const int64_t per_warp) {
  using SU = Step<BY4, typename Kind<KIND>::U>;
  using SV = Step<BY4, typename Kind<KIND>::V>;
  constexpr int D = 6;
  constexpr int64_t BLOCK = 32 * SU::W;   // columns a block of steps
  const int lane = threadIdx.x % 32;
  const int64_t tiles = (p.E + 31) / 32;
  const int64_t first = ((int64_t)blockIdx.x * WARPS + threadIdx.x / 32)
                        * per_warp;
  const int64_t end = first + per_warp < tiles ? first + per_warp : tiles;
  const bool carry = p.K <= BLOCK;
  typename SU::Raw ub[D], u = SU::zero();
  typename SV::Raw vb[D];
#pragma unroll
  for (int s = 0; s < D; ++s) {
    ub[s] = SU::zero();
    vb[s] = SV::zero();
  }
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
      const int64_t k = kb + lane * SU::W;
#pragma unroll
      for (int t = 0; t < D; ++t)
        fetch<BY4, KIND>(p, k, r, c, t, load_u, ok, ub[t], vb[t]);
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const int s = t % D;
        if ((fresh >> t) & 1u) u = ub[s];
        if (k < p.K)
          acc[t] = dot_step(SU::wide(u), SV::wide(vb[s]), acc[t]);
        if (t + D < 32)
          fetch<BY4, KIND>(p, k, r, c, t + D, load_u, ok, ub[s], vb[s]);
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
template <bool BY4, int KIND>
void launch_tiles(const Pairs<KIND>& p, cudaStream_t stream) {
  static const int64_t resident = [] {
    int dev = 0, sms = 0, blocks = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, sddmm_tiles_kernel<BY4, KIND>, THREADS, 0);
    return (int64_t)(sms > 0 ? sms : 1) * (blocks > 0 ? blocks : 1) * WARPS;
  }();
  const int64_t tiles = (p.E + 31) / 32;
  const int64_t per_warp = (tiles + resident - 1) / resident;
  const int64_t warps = (tiles + per_warp - 1) / per_warp;
  sddmm_tiles_kernel<BY4, KIND>
      <<<(unsigned)((warps + WARPS - 1) / WARPS), THREADS, 0, stream>>>(
          p, per_warp);
}

template <int KIND>
int launch(const Pairs<KIND>& p, int by4, void* stream) {
  if (p.E <= 0) return (int)cudaGetLastError();
  if (by4)
    launch_tiles<true, KIND>(p, (cudaStream_t)stream);
  else
    launch_tiles<false, KIND>(p, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

template <typename E>
int launch_pregathered(const void* ug, const void* vg, void* out, int64_t n,
                       int64_t K, int vec, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  sddmm_kernel<E><<<(unsigned)grid_for(n), THREADS, 0,
                    (cudaStream_t)stream>>>((const E*)ug, (const E*)vg,
                                            (float*)out, n, K, vec);
  return (int)cudaGetLastError();
}

template <int KIND>
int gathered(const void* U, const void* V, const void* i, const void* j,
             void* out, int64_t E, int64_t K, int64_t n_u, int64_t n_v,
             int by4, void* stream) {
  const Pairs<KIND> p{(const typename Kind<KIND>::U*)U,
                      (const typename Kind<KIND>::V*)V, (const int*)i,
                      (const int*)j, (float*)out, E, 1, K, n_u, n_v};
  return launch(p, by4, stream);
}

template <int KIND>
int padded(const void* U, const void* V, const void* idx, void* out,
           int64_t R, int64_t T, int64_t K, int64_t n_v, int by4,
           void* stream) {
  const Pairs<KIND> p{(const typename Kind<KIND>::U*)U,
                      (const typename Kind<KIND>::V*)V, nullptr,
                      (const int*)idx, (float*)out, R * T, T, K, R, n_v};
  return launch(p, by4, stream);
}

}  // namespace

// ug, vg (E, K) fp32, contiguous -> out (E,) fp32.
// vec != 0 promises K % 4 == 0 and 16-byte aligned ug and vg.
// Returns the cudaError_t of the launch.
extern "C" int sddmm_f32(const void* ug, const void* vg, void* out,
                         int64_t E, int64_t K, int vec, void* stream) {
  return launch_pregathered<float>(ug, vg, out, E, K, vec, stream);
}

// The same with bf16 ug and vg; vec != 0 promises K % 4 == 0 and
// 8-byte aligned ug and vg.
extern "C" int sddmm_bf16(const void* ug, const void* vg, void* out,
                          int64_t E, int64_t K, int vec, void* stream) {
  return launch_pregathered<__nv_bfloat16>(ug, vg, out, E, K, vec, stream);
}

// U (n_u, K), V (n_v, K) fp32, contiguous, 16-byte aligned; i, j (E,)
// int32 -> out (E,) fp32.  by4 != 0 promises K % 4 == 0 (the k order
// of sddmm_f32's vec path).  Returns the cudaError_t of the launch.
extern "C" int sddmm_gathered_f32(const void* U, const void* V,
                                  const void* i, const void* j, void* out,
                                  int64_t E, int64_t K, int64_t n_u,
                                  int64_t n_v, int by4, void* stream) {
  return gathered<0>(U, V, i, j, out, E, K, n_u, n_v, by4, stream);
}

// The same with bf16 U and V (the order of sddmm_bf16's vec path).
extern "C" int sddmm_gathered_bf16(const void* U, const void* V,
                                   const void* i, const void* j, void* out,
                                   int64_t E, int64_t K, int64_t n_u,
                                   int64_t n_v, int by4, void* stream) {
  return gathered<1>(U, V, i, j, out, E, K, n_u, n_v, by4, stream);
}

// U (R, K), V (n_v, K) fp32, contiguous, 16-byte aligned; idx (R, T)
// int32 -> out (R, T) fp32, out[r, t] = U[r] . V[idx[r, t]]: the
// gathered entry with i = the slot's row.  by4 as above.
extern "C" int sddmm_padded_f32(const void* U, const void* V,
                                const void* idx, void* out, int64_t R,
                                int64_t T, int64_t K, int64_t n_v, int by4,
                                void* stream) {
  return padded<0>(U, V, idx, out, R, T, K, n_v, by4, stream);
}

// The same with bf16 U and V.
extern "C" int sddmm_padded_bf16(const void* U, const void* V,
                                 const void* idx, void* out, int64_t R,
                                 int64_t T, int64_t K, int64_t n_v, int by4,
                                 void* stream) {
  return padded<1>(U, V, idx, out, R, T, K, n_v, by4, stream);
}

// The same with fp32 U against bf16 V.
extern "C" int sddmm_padded_mixed(const void* U, const void* V,
                                  const void* idx, void* out, int64_t R,
                                  int64_t T, int64_t K, int64_t n_v, int by4,
                                  void* stream) {
  return padded<2>(U, V, idx, out, R, T, K, n_v, by4, stream);
}
