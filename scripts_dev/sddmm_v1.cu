// The first design of sddmm's fused-gather entry (sddmm_gathered_f32 of
// src/repro_torch/kernels/csrc/sddmm.cu before its redesign for Hopper),
// kept to be timed beside the current one and held bitwise against it.
//
//   sddmm_v1_gathered_f32: pred[e] = sum_k U[i[e],k] * V[j[e],k]
//
// One warp owns one entry: it loads the rows U[i[e]] and V[j[e]] (a
// float4 of each a lane for K % 4 == 0, else one float a lane), runs
// each lane's ascending fmaf chain over its columns, adds the 32
// partials in the xor-shuffle tree off = 16, 8, 4, 2, 1, and lane 0
// writes the entry.  A grid-stride loop covers any E.  A row index
// outside [0, n) reads a zero row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
sddmm_gathered_kernel(const float* __restrict__ U,
                      const float* __restrict__ V,
                      const int* __restrict__ ii, const int* __restrict__ jj,
                      float* __restrict__ out, int64_t E, int64_t K,
                      int64_t n_u, int64_t n_v, int by4) {
  const int lane = threadIdx.x % 32;
  const int64_t first = (int64_t)blockIdx.x * WARPS + threadIdx.x / 32;
  const int64_t stride = (int64_t)gridDim.x * WARPS;
  for (int64_t e = first; e < E; e += stride) {
    const int64_t r = ii[e];
    const int64_t c = jj[e];
    float s = 0.f;
    if (r >= 0 && r < n_u && c >= 0 && c < n_v) {
      const float* u = U + r * K;
      const float* v = V + c * K;
      if (by4) {
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
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) out[e] = s;
  }
}

int64_t grid_for(int64_t E) {
  int64_t blocks = (E + WARPS - 1) / WARPS;
  return blocks > 1048576 ? 1048576 : blocks;
}

}  // namespace

// U (n_u, K), V (n_v, K) fp32, contiguous, 16-byte aligned; i, j (E,)
// int32 -> out (E,) fp32.  by4 != 0 promises K % 4 == 0.  Returns the
// cudaError_t of the launch.
extern "C" int sddmm_v1_gathered_f32(const void* U, const void* V,
                                     const void* i, const void* j,
                                     void* out, int64_t E, int64_t K,
                                     int64_t n_u, int64_t n_v, int by4,
                                     void* stream) {
  if (E <= 0) return (int)cudaGetLastError();
  sddmm_gathered_kernel<<<(unsigned)grid_for(E), THREADS, 0,
                          (cudaStream_t)stream>>>(
      (const float*)U, (const float*)V, (const int*)i, (const int*)j,
      (float*)out, E, K, n_u, n_v, by4);
  return (int)cudaGetLastError();
}
