// Posterior scoring and stable top-k, fp32, for Hopper (sm_90a).
//
// For each user b, against every item n across every retained sample s:
//   score[s, n] = us[b, s, :] . v[s, n, :]
//   mean[n]     = (sum_s score[s, n]) * (1/S)
//   ex2[n]      = (sum_s score[s, n]^2) * (1/S)
//   rank[n]     = -inf where excl[b, n] > 0, else mean[n]
// and the k items of highest rank, ties to the lowest item id, with
// their mean and ex2 (excluded items keep their true mean and ex2).
//
// Replaces the Pallas-TPU kernel src/repro/kernels/topk_score.py
// (topk_score_pallas / _topk_kernel, pallas_call at line 139).  That
// kernel walks the items in order on one core and carries a running
// top-k from one item tile to the next, selecting with a k-step
// unrolled argmax.  Blocks of a CUDA grid run in no order, so nothing
// carries over between them; the design is two passes instead:
//
// * pass 1, scoring and a local top-k: one block per (user, chunk of
//   items).  The block stages us[b] (S*K floats) in shared memory; one
//   warp scores one item at a time: each lane loads float4s of the
//   item's row of each sample, the warp adds the lanes' partial dot
//   products with xor shuffles, and the S scores are summed into mean
//   and E[s^2] in sample order.  Every item is scored by the same
//   fixed sequence of operations whatever the batch or the chunk size.
//   The chunk's (rank, item) keys are then sorted in shared memory
//   (bitonic) and its first k candidates go to a scratch list;
// * pass 2, merge: one block per (user, group of lists) sorts the
//   group's candidates the same way and keeps the first k.  Rounds
//   repeat until one list is left, written to the outputs.
//
// The sort key is 64-bit: the high word orders the rank DESCENDING
// (floats mapped to orderable integers, -0.0 first made +0.0 so that
// the two tie, as in jnp.argsort), the low word is the item's place in
// the chunk or the candidate's place in the group.  Within a chunk and
// across the chunks of a group, places rise with item ids, so ties go
// to the lowest id.  Selection is exact, so the chunk size (which the
// wrapper picks from the grid's size) changes no answer; there are no
// atomics and nothing is summed across users: the result is the same
// bits on every run and for a user whatever B is.
//
// What bounds it on an H100: the memory.  Each user reads the item
// stack, S*N*K*4 bytes, for 2*S*N*K operations: half an operation per
// byte.  The least time reads the stack once for the whole batch; this
// first design reads it once per user (blocks of one chunk run side by
// side, so part of the re-reading hits L2).  Sharing one tile of V
// across the users of a batch, TMA and wgmma are later work.  Every
// offset is 64-bit: a store of 128 samples of 131,072 x 128 items has
// 2^31 elements.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr uint64_t PAD = ~0ull;          // sorts after every candidate
constexpr uint32_t PAD_RANK = 0xFFFFFFFFu;

// One set of candidate lists, (B, L, k) each.
struct Lists {
  uint32_t* rank;   // descending-rank key (high word of the sort key)
  int32_t* id;      // item id, -1 for padding
  float* mean;
  float* ex2;
};

// A 32-bit key whose ascending order is the rank's DESCENDING order.
__device__ __forceinline__ uint32_t desc_key(float r) {
  uint32_t u = __float_as_uint(r);
  if ((u << 1) == 0u) u = 0u;            // -0.0 ties with +0.0
  const uint32_t ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ~ord;
}

// Ascending bitonic sort of n keys (a power of 2) in shared memory, by
// every thread of the block; the caller synchronises before it.
__device__ void bitonic_sort(uint64_t* a, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < n / 2; i += THREADS) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const uint64_t x = a[lo], y = a[hi];
        if ((x > y) == ((lo & size) == 0)) {
          a[lo] = y;
          a[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ float warp_sum(float p) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    p += __shfl_xor_sync(0xffffffffu, p, off);
  return p;
}

// Pass 1: block (b, c) scores items [c*chunk, (c+1)*chunk) for user b
// and writes its first k candidates to list c of user b.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
score_kernel(const float* __restrict__ us, const float* __restrict__ v,
             const float* __restrict__ excl, int64_t S, int64_t N,
             int64_t K, int chunk, int k, float inv_s, Lists out,
             int64_t L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t b = blockIdx.x;
  const int64_t c = blockIdx.y;
  const int64_t base = c * chunk;
  const int64_t SK = S * K;
  float* su = reinterpret_cast<float*>(smem);
  uint64_t* skey = reinterpret_cast<uint64_t*>(su + (SK + 3) / 4 * 4);
  float* smean = reinterpret_cast<float*>(skey + chunk);
  float* sex2 = smean + chunk;

  const float* ub = us + b * SK;
  for (int64_t i = threadIdx.x; i < SK; i += THREADS) su[i] = ub[i];
  __syncthreads();

  const int lane = threadIdx.x % 32;
  for (int j = threadIdx.x / 32; j < chunk; j += WARPS) {
    const int64_t n = base + j;
    if (n >= N) {
      if (lane == 0) skey[j] = PAD;
      continue;
    }
    float msum = 0.f, qsum = 0.f;
    int64_t s = 0;
    if (VEC) {
      // four samples at a time: four independent row loads in flight
      for (; s + 4 <= S; s += 4) {
        float p[4] = {0.f, 0.f, 0.f, 0.f};
        for (int64_t kk = lane * 4; kk < K; kk += 128) {
          float4 a[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            a[q] = __ldg(reinterpret_cast<const float4*>(
                v + ((s + q) * N + n) * K + kk));
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 u =
                *reinterpret_cast<const float4*>(su + (s + q) * K + kk);
            p[q] = fmaf(a[q].x, u.x, p[q]);
            p[q] = fmaf(a[q].y, u.y, p[q]);
            p[q] = fmaf(a[q].z, u.z, p[q]);
            p[q] = fmaf(a[q].w, u.w, p[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float t = warp_sum(p[q]);
          msum += t;
          qsum += t * t;
        }
      }
    }
    for (; s < S; ++s) {
      const float* vr = v + (s * N + n) * K;
      const float* ur = su + s * K;
      float p = 0.f;
      if (VEC) {
        for (int64_t kk = lane * 4; kk < K; kk += 128) {
          const float4 a = __ldg(reinterpret_cast<const float4*>(vr + kk));
          const float4 u = *reinterpret_cast<const float4*>(ur + kk);
          p = fmaf(a.x, u.x, p);
          p = fmaf(a.y, u.y, p);
          p = fmaf(a.z, u.z, p);
          p = fmaf(a.w, u.w, p);
        }
      } else {
        for (int64_t kk = lane; kk < K; kk += 32)
          p = fmaf(__ldg(vr + kk), ur[kk], p);
      }
      const float t = warp_sum(p);
      msum += t;
      qsum += t * t;
    }
    if (lane == 0) {
      const float mean = msum * inv_s;
      const float rank = excl[b * N + n] > 0.f
                             ? __uint_as_float(0xff800000u)  // -inf
                             : mean;
      skey[j] = ((uint64_t)desc_key(rank) << 32) | (uint32_t)j;
      smean[j] = mean;
      sex2[j] = qsum * inv_s;
    }
  }
  __syncthreads();
  bitonic_sort(skey, chunk);

  const int64_t o = (b * L + c) * k;
  for (int r = threadIdx.x; r < k; r += THREADS) {
    const uint64_t key = skey[r];
    const bool pad = key == PAD;
    const uint32_t j = (uint32_t)key;
    if (out.rank) out.rank[o + r] = pad ? PAD_RANK : (uint32_t)(key >> 32);
    out.id[o + r] = pad ? -1 : (int32_t)(base + j);
    out.mean[o + r] = pad ? 0.f : smean[j];
    out.ex2[o + r] = pad ? 0.f : sex2[j];
  }
}

// Pass 2: block (b, g) merges lists [g*group, (g+1)*group) of user b
// (adjacent in memory) into list g of the output.
__global__ void __launch_bounds__(THREADS)
merge_kernel(Lists in, int64_t L_in, Lists out, int64_t L_out, int k,
             int group, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* skey = reinterpret_cast<uint64_t*>(smem);
  const int64_t b = blockIdx.x;
  const int64_t g = blockIdx.y;
  const int64_t first = g * group;
  const int64_t n_lists = L_in - first < group ? L_in - first : group;
  const int m = (int)(n_lists * k);
  const int64_t i0 = (b * L_in + first) * k;
  for (int i = threadIdx.x; i < cap; i += THREADS)
    skey[i] = i < m ? ((uint64_t)in.rank[i0 + i] << 32) | (uint32_t)i
                    : PAD;
  __syncthreads();
  bitonic_sort(skey, cap);

  const int64_t o = (b * L_out + g) * k;
  for (int r = threadIdx.x; r < k; r += THREADS) {
    const int64_t i = i0 + (uint32_t)skey[r];
    if (out.rank) out.rank[o + r] = in.rank[i];
    out.id[o + r] = in.id[i];
    out.mean[o + r] = in.mean[i];
    out.ex2[o + r] = in.ex2[i];
  }
}

Lists lists_at(void* base, int64_t entries) {
  uint32_t* p = static_cast<uint32_t*>(base);
  return Lists{p, reinterpret_cast<int32_t*>(p + entries),
               reinterpret_cast<float*>(p + 2 * entries),
               reinterpret_cast<float*>(p + 3 * entries)};
}

}  // namespace

// us (B, S, K), v (S, N, K), excl (B, N) fp32, contiguous ->
// ids (B, k) int32, mean (B, k), ex2 (B, k) fp32.
// chunk: items a scoring block ranks (a power of 2, k <= chunk);
// group: lists a merge block takes (group * k <= 4096).
// scratch: 2 * B * ceil(N / chunk) * k * 16 bytes.
// vec != 0 promises K % 4 == 0 and 16-byte aligned us and v.
// Returns the first cudaError_t of the launches.
extern "C" int topk_score_f32(const void* us, const void* v,
                              const void* excl, void* ids, void* mean,
                              void* ex2, void* scratch, int64_t B,
                              int64_t S, int64_t N, int64_t K, int64_t k,
                              int64_t chunk, int64_t group, int vec,
                              void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  int64_t L = (N + chunk - 1) / chunk;
  const int64_t entries = B * L * k;
  Lists cur = lists_at(scratch, entries);
  Lists other = lists_at(static_cast<uint32_t*>(scratch) + 4 * entries,
                         entries);
  const Lists final_out{nullptr, static_cast<int32_t*>(ids),
                        static_cast<float*>(mean),
                        static_cast<float*>(ex2)};

  const size_t smem = (size_t)((S * K + 3) / 4 * 4) * sizeof(float) +
                      (size_t)chunk * (sizeof(uint64_t) + 2 * sizeof(float));
  const float inv_s = 1.0f / (float)S;
  const dim3 grid1((unsigned)B, (unsigned)L);
  const Lists out1 = L == 1 ? final_out : cur;
  cudaError_t err;
  if (vec) {
    err = cudaFuncSetAttribute(score_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    score_kernel<true><<<grid1, THREADS, smem, st>>>(
        (const float*)us, (const float*)v, (const float*)excl, S, N, K,
        (int)chunk, (int)k, inv_s, out1, L);
  } else {
    err = cudaFuncSetAttribute(score_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    score_kernel<false><<<grid1, THREADS, smem, st>>>(
        (const float*)us, (const float*)v, (const float*)excl, S, N, K,
        (int)chunk, (int)k, inv_s, out1, L);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  int cap = 1;
  while (cap < group * k) cap <<= 1;
  while (L > 1) {
    const int64_t L_out = (L + group - 1) / group;
    const Lists dst = L_out == 1 ? final_out : other;
    merge_kernel<<<dim3((unsigned)B, (unsigned)L_out), THREADS,
                   (size_t)cap * sizeof(uint64_t), st>>>(
        cur, L, dst, L_out, (int)k, (int)group, cap);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const Lists t = cur;
    cur = other;
    other = t;
    L = L_out;
  }
  return (int)cudaSuccess;
}
