// The first design of the masked-Gram kernel (src/repro_torch/kernels/
// csrc/gram.cu before its Hopper redesign), kept to be timed beside the
// current one: scripts_dev/gram_v1.py builds and launches it.
//
// Masked per-row Gram and right-hand side, fp32, for Hopper (sm_90a).
//
//   gram[r] = sum_t mask[r,t] * vg[r,t,:] vg[r,t,:]^T      (K x K)
//   rhs[r]  = sum_t mask[r,t] * val[r,t] * vg[r,t,:]       (K)
//
// Replaces the Pallas-TPU kernel src/repro/kernels/gram.py
// (gram_pallas / _gram_kernel, pallas_call at line 83), which walks a
// (row-block, nnz-block) grid in order and accumulates each row block's
// output in VMEM across the nnz axis.
//
// What bounds it on an H100: the arithmetic, or at short rows both.  A
// row does 2*T*K^2 fp32 operations, reads T*K*4 bytes and writes
// K*K*4.  Fp32 outside the tensor cores (67 TFLOP/s) meets the memory
// (3.35 TB/s) at 20 operations per byte; at K = 128 a row with T = 64
// does 21 per byte (the K x K output dominates the bytes), one with
// T = 1,152 does 120.  So the design keeps the FMA units fed and
// writes the output once:
//
// * one block owns one row and one 128x128 tile of its output (for
//   K <= 128 the whole output), so a row's sum never leaves the block
//   and needs no atomics; t is walked in a fixed order, so the result
//   is the same bits on every run;
// * the Gram is symmetric, so only the tiles on and below the diagonal
//   are computed, and in a diagonal tile the upper-right 64x64
//   quadrant is skipped: each is written again at its transposed
//   place.  At K = 128 that saves a quarter of the FMAs;
// * the row's (T, K) slab streams through shared memory in chunks of
//   CH rows of t; each of the 256 threads holds an 8x8 block of the
//   output in registers (three of its four 4x4 quadrants in a diagonal
//   tile) and reads two float4 of each operand per t, so shared memory
//   delivers 16 operands for 48 or 64 FMAs.  The next chunk's loads
//   are issued into registers before the current chunk is used, so
//   their latency hides behind the FMAs;
// * ragged edges (t >= T, k >= K) are masked in the loads and stores,
//   so callers pass any T and K without padding;
// * every offset is 64-bit: at R = 131,072 rows and K = 128 the output
//   has exactly 2^31 elements.
//
// Tensor cores (wgmma on TF32 or bf16) and a gather fused into the
// load are later work; this kernel keeps the fp32 contract of the
// reference.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TILE = 128;     // output tile edge
constexpr int HALF = TILE / 2;
constexpr int CH = 16;        // t steps per shared-memory chunk
constexpr int THREADS = 256;  // 16 x 16 threads, 8 x 8 outputs each
// elements of one chunk's (CH x TILE) operand slice a thread loads
constexpr int PER = CH * TILE / THREADS;          // scalars
constexpr int PER4 = PER / 4;                     // float4s

// One chunk of a row's operands, held in registers between its global
// loads and its store to shared memory.
struct Chunk {
  float a[PER];   // vg over the i-range
  float b[PER];   // vg over the j-range (off-diagonal tiles only)
  float m[PER];   // mask at each element's t
  float w;        // val * mask at t0 + tid (threads tid < CH)
};

// Element e of a thread's share: scalar k or float4 k*4.
template <bool VEC>
__device__ __forceinline__ void chunk_index(int tid, int k, int& tt,
                                            int& kk) {
  if (VEC) {
    const int e = tid + k * THREADS;  // float4 index in the chunk
    tt = e / (TILE / 4);
    kk = (e % (TILE / 4)) * 4;
  } else {
    const int e = tid + k * THREADS;
    tt = e / TILE;
    kk = e % TILE;
  }
}

template <bool VEC, bool DIAG>
__device__ __forceinline__ void load_chunk(
    Chunk& c, const float* __restrict__ vrow, const float* __restrict__ mrow,
    const float* __restrict__ wrow, int64_t t0, int64_t T, int64_t K,
    int64_t i0, int64_t j0, int tid) {
  constexpr int N = VEC ? PER4 : PER;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    int tt, kk;
    chunk_index<VEC>(tid, k, tt, kk);
    const int64_t t = t0 + tt;
    const bool in_t = t < T;
    const float m = in_t ? mrow[t] : 0.f;
    if (VEC) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      if (in_t && i0 + kk < K)
        a = *reinterpret_cast<const float4*>(vrow + t * K + i0 + kk);
      c.a[4 * k] = a.x; c.a[4 * k + 1] = a.y;
      c.a[4 * k + 2] = a.z; c.a[4 * k + 3] = a.w;
      if (!DIAG) {
        float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
        if (in_t && j0 + kk < K)
          b = *reinterpret_cast<const float4*>(vrow + t * K + j0 + kk);
        c.b[4 * k] = b.x; c.b[4 * k + 1] = b.y;
        c.b[4 * k + 2] = b.z; c.b[4 * k + 3] = b.w;
      }
      c.m[k] = m;
    } else {
      c.a[k] = (in_t && i0 + kk < K) ? vrow[t * K + i0 + kk] : 0.f;
      if (!DIAG) c.b[k] = (in_t && j0 + kk < K) ? vrow[t * K + j0 + kk] : 0.f;
      c.m[k] = m;
    }
  }
  if (DIAG && tid < CH) {
    const int64_t t = t0 + tid;
    c.w = t < T ? wrow[t] * mrow[t] : 0.f;
  }
}

template <bool VEC, bool DIAG>
__device__ __forceinline__ void store_chunk(const Chunk& c,
                                            float (*As)[TILE],
                                            float (*Bs)[TILE], float* Ws,
                                            int tid) {
  constexpr int N = VEC ? PER4 : PER;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    int tt, kk;
    chunk_index<VEC>(tid, k, tt, kk);
    if (VEC) {
      const float m = c.m[k];
      *reinterpret_cast<float4*>(&As[tt][kk]) =
          make_float4(c.a[4 * k] * m, c.a[4 * k + 1] * m,
                      c.a[4 * k + 2] * m, c.a[4 * k + 3] * m);
      *reinterpret_cast<float4*>(&Bs[tt][kk]) =
          DIAG ? make_float4(c.a[4 * k], c.a[4 * k + 1], c.a[4 * k + 2],
                             c.a[4 * k + 3])
               : make_float4(c.b[4 * k], c.b[4 * k + 1], c.b[4 * k + 2],
                             c.b[4 * k + 3]);
    } else {
      As[tt][kk] = c.a[k] * c.m[k];
      Bs[tt][kk] = DIAG ? c.a[k] : c.b[k];
    }
  }
  if (DIAG && tid < CH) Ws[tid] = c.w;
}

// DIAG: blockIdx.y = ti = tj; the upper-right quadrant is mirrored.
// Otherwise blockIdx.y enumerates the tile pairs ti > tj, and the whole
// tile is mirrored to (tj, ti).
template <bool VEC, bool DIAG>
__global__ void __launch_bounds__(THREADS, 2)
gram_kernel(const float* __restrict__ vg, const float* __restrict__ val,
            const float* __restrict__ mask, float* __restrict__ gram,
            float* __restrict__ rhs, int64_t T, int64_t K) {
  __shared__ __align__(16) float As[CH][TILE];  // vg * mask, i-range
  __shared__ __align__(16) float Bs[CH][TILE];  // vg, j-range
  __shared__ float Ws[CH];                      // val * mask

  const int64_t row = blockIdx.x;
  int ti, tj;
  if (DIAG) {
    ti = tj = blockIdx.y;
  } else {
    int p = blockIdx.y;
    ti = 1;
    while (p >= ti) { p -= ti; ++ti; }
    tj = p;
  }
  const int64_t i0 = (int64_t)ti * TILE;
  const int64_t j0 = (int64_t)tj * TILE;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const float* vrow = vg + row * T * K;
  const float* mrow = mask + row * T;
  const float* wrow = val + row * T;

  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;
  float racc = 0.f;

  Chunk c;
  load_chunk<VEC, DIAG>(c, vrow, mrow, wrow, 0, T, K, i0, j0, tid);
  for (int64_t t0 = 0; t0 < T; t0 += CH) {
    store_chunk<VEC, DIAG>(c, As, Bs, Ws, tid);
    __syncthreads();
    if (t0 + CH < T)
      load_chunk<VEC, DIAG>(c, vrow, mrow, wrow, t0 + CH, T, K, i0, j0, tid);

#pragma unroll
    for (int tt = 0; tt < CH; ++tt) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[tt][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[tt][HALF + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[tt][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[tt][HALF + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (!DIAG || p >= 4 || q < 4)   // skip (a0, b1) on the diagonal
            acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
    }
    // the diagonal tile's Bs holds the i-range of vg unmasked: rhs
    if (DIAG && tid < TILE) {
#pragma unroll
      for (int tt = 0; tt < CH; ++tt) racc = fmaf(Bs[tt][tid], Ws[tt], racc);
    }
    __syncthreads();
  }

  float* out = gram + row * K * K;
  // computed quadrants at their own place: rows gi, columns gj
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int64_t gi = i0 + (p < 4 ? ty * 4 + p : HALF + ty * 4 + p - 4);
    if (gi >= K) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (DIAG && p < 4 && h == 1) continue;
      const int64_t gj = j0 + h * HALF + tx * 4;
      if (VEC) {
        if (gj < K)
          *reinterpret_cast<float4*>(out + gi * K + gj) =
              make_float4(acc[p][h * 4], acc[p][h * 4 + 1],
                          acc[p][h * 4 + 2], acc[p][h * 4 + 3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (gj + q < K) out[gi * K + gj + q] = acc[p][h * 4 + q];
      }
    }
  }
  // mirrored: column gj of the computed block becomes row gj; on the
  // diagonal only the (a1, b0) quadrant, off it the whole block
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    if (DIAG && q >= 4) continue;
    const int64_t gj = j0 + (q < 4 ? tx * 4 + q : HALF + tx * 4 + q - 4);
    if (gj >= K) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (DIAG && h == 0) continue;
      const int64_t gi = i0 + h * HALF + ty * 4;
      if (VEC) {
        if (gi < K)
          *reinterpret_cast<float4*>(out + gj * K + gi) =
              make_float4(acc[h * 4][q], acc[h * 4 + 1][q],
                          acc[h * 4 + 2][q], acc[h * 4 + 3][q]);
      } else {
#pragma unroll
        for (int p = 0; p < 4; ++p)
          if (gi + p < K) out[gj * K + gi + p] = acc[h * 4 + p][q];
      }
    }
  }
  if (DIAG && tid < TILE && i0 + tid < K) rhs[row * K + i0 + tid] = racc;
}

template <bool VEC>
cudaError_t launch(const float* vg, const float* val, const float* mask,
                   float* gram, float* rhs, int64_t R, int64_t T, int64_t K,
                   cudaStream_t stream) {
  const int64_t n = (K + TILE - 1) / TILE;
  gram_kernel<VEC, true><<<dim3((unsigned)R, (unsigned)n), THREADS, 0,
                           stream>>>(vg, val, mask, gram, rhs, T, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n == 1) return err;
  gram_kernel<VEC, false><<<dim3((unsigned)R, (unsigned)(n * (n - 1) / 2)),
                            THREADS, 0, stream>>>(vg, val, mask, gram, rhs,
                                                  T, K);
  return cudaGetLastError();
}

}  // namespace

// vg (R, T, K), val (R, T), mask (R, T) fp32, contiguous
//   -> gram (R, K, K), rhs (R, K) fp32.
// vec != 0 promises K % 4 == 0 and 16-byte aligned vg and gram.
// Returns the cudaError_t of the launch.
extern "C" int gram_f32(const void* vg, const void* val, const void* mask,
                        void* gram, void* rhs, int64_t R, int64_t T,
                        int64_t K, int vec, void* stream) {
  if (R <= 0 || K <= 0) return (int)cudaGetLastError();
  const int64_t n = (K + TILE - 1) / TILE;
  if (R > 0x7fffffffLL || n * (n - 1) / 2 > 65535)
    return (int)cudaErrorInvalidValue;
  const auto f = [&](auto tag) {
    return launch<decltype(tag)::value>(
        (const float*)vg, (const float*)val, (const float*)mask,
        (float*)gram, (float*)rhs, R, T, K, (cudaStream_t)stream);
  };
  const cudaError_t err = vec ? f(std::true_type{}) : f(std::false_type{});
  return (int)err;
}
