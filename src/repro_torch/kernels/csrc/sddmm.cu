// SDDMM, fp32, for Hopper (sm_90a), with two entries:
//
//   sddmm_f32:          pred[e] = sum_k ug[e,k] * vg[e,k]
//   sddmm_gathered_f32: pred[e] = sum_k U[i[e],k] * V[j[e],k]
//
// Replaces the Pallas-TPU kernel src/repro/kernels/sddmm.py
// (sddmm_pallas / _sddmm_kernel, pallas_call at line 53), which tiles
// (E, K) into (512, 128) VMEM blocks and accumulates over the K axis.
//
// What bounds it on an H100: the memory.  Each entry reads 2*K*4 bytes
// and does 2*K operations, a quarter of an operation per byte, so the
// least time is the bytes over 3.35 TB/s.  The design reads each byte
// once in full 128-byte lines: one warp owns one entry, each lane
// loads a float4 of both operands per step (one 512-byte line per
// operand for K = 128), keeps a fp32 partial sum, and the warp adds the
// 32 partials with shuffles in a fixed order.  There are no atomics
// and no shared memory; a grid-stride loop covers any E, and every
// offset is 64-bit.
//
// The gathered entry reads the rows U[i[e]] and V[j[e]] in its loads,
// so the sweep needs no (E, K) copies of them (two index_selects of
// 4.3 GB each at 8,388,608 entries and K = 128).  It runs the same
// per-entry program: every lane walks its k in the same order with the
// same fmaf chain and the warp adds the partials in the same shuffle
// order, so it gives bitwise what sddmm_f32 gives on the gathered rows.
// For K % 4 == 0 a lane takes four consecutive k per step in float4
// loads (the wrapper refuses U or V that is not 16-byte aligned); else
// one k per step.  A row index outside [0, n) reads a zero row.  Rows that several entries share come through L2; making
// use of that reuse is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

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
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) out[e] = s;
  }
}

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
  if (E <= 0) return (int)cudaGetLastError();
  sddmm_gathered_kernel<<<(unsigned)grid_for(E), THREADS, 0,
                          (cudaStream_t)stream>>>(
      (const float*)U, (const float*)V, (const int*)i, (const int*)j,
      (float*)out, E, K, n_u, n_v, by4);
  return (int)cudaGetLastError();
}
