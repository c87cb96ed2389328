// Posterior scoring and stable top-k for Hopper (sm_90a): fp32 operands
// (topk_score_f32), or bf16 ones (topk_score_bf16: both us and v bf16,
// the reference's bf16 branch), always summed in fp32.
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
// top-k from one item tile to the next.  Blocks of a CUDA grid run in
// no order and share nothing, so scoring and selection are separate
// passes here, joined by a scratch buffer of (rank key, mean, E[s^2])
// for every (user, item): 12 bytes each, 12.6 MB at B = 8, N = 131,072.
//
// * Scoring (score_kernel): one block per (tile of TN items, group of up
//   to 8 users), the groups of a tile side by side in the grid so that
//   they read the tile from L2.  The block streams the stack through
//   shared memory in stages: one sample's slice of up to 32 * NB floats
//   of K for the tile's items (V[s, tile, k0:k1]) and for the group's
//   rows (us[g, s, k0:k1]).  One thread issues a stage as 3-d TMA boxes
//   (128-byte swizzle; rows past N, users past B and columns past K
//   arrive as zeros); three stages are in flight on mbarriers, and two
//   blocks share an SM.  So the item stack is read once per group of 8
//   users, not once per user, and no buffer holds a user's S x K rows:
//   S and K are unbounded.  A thread owns one item and 8 / (256 / TN)
//   users; it reads its item's 16 bytes of a box row (the swizzle
//   spreads 8 neighbouring rows over the 32 banks) and each user's 16
//   bytes (a broadcast: the warp's users are one), and keeps each
//   pair's dot product, sum and sum of squares in registers.  Operands
//   that TMA cannot take (K % 4 != 0, a pointer not 16-byte aligned)
//   are staged by plain loads into the same layout, a stage at a time.
// * One sequence of operations per (user, item): for s = 0..S-1, d is
//   the fma chain over k = 0..K-1 in order from +0, then sum += d and
//   sq = fma(d, d, sq).  It depends on S and K alone: not on B, the
//   user's place in its group, TN, the staging or the grid, and no sum
//   uses atomics.  So a batched call is the same bits as one call per
//   user, and as itself run again.
// * Selection keeps a user's k best keys by radix select (select_k): the
//   k-th smallest 32-bit rank word T by 8-bit digits, one histogram a
//   digit, then every key of better rank and, of the keys at T, the
//   lowest ids (a prefix count in id order).  k <= 1,024
//   (select_kernel): one block per (user, chunk of up to 8,192 items)
//   selects in shared memory and writes the chunk's k survivors; rounds
//   select the same way from groups of those lists until one is left,
//   whose k survivors are sorted (bitonic) into the outputs.  k > 1,024
//   (radix_kernel, tile_sort_kernel, merge_pass_kernel): one block per
//   user selects from its N keys in L2; the k survivors are sorted in
//   tiles of 4,096 in shared memory (bitonic), then in rounds that merge
//   pairs of sorted runs, each key finding its place by a binary search
//   in the other run.
//
// The sort key is 64-bit: the high word orders the rank DESCENDING
// (floats mapped to orderable integers, -0.0 first made +0.0 so that
// the two tie, as in jnp.argsort), the low word is the item id.  Keys
// are unique, so the first k are one set in one order whatever the
// route or the chunk size, and ties go to the lowest id.
//
// bf16 (topk_score_bf16).  The item stack and the user rows are read as
// bf16 through their own tensor maps: boxes of the same 32 elements of
// K, 64 bytes a box row instead of 128, with the 64-byte swizzle (the
// 16-byte chunk index XORed with bits 7-8 of the address, so the 8 rows
// a quarter-warp reads fall on all 32 banks).  A thread reads 16 bytes
// (8 elements) of its item's box row and of each user's, widens them
// exactly to fp32 and runs the fp32 program's fmaf chain over them in
// the same k order: the product of two bf16 values is exact in fp32, so
// each (user, item) gives the bits of the fp32 kernel on the widened
// operands, and the batch contract holds as in fp32.  A stage holds half
// the bytes; selection is unchanged.  The plain-load staging takes
// K % 8 != 0 or pointers off 16 bytes.
//
// What bounds it on an H100: the memory.  The least time reads the
// item stack once, S*N*K*4 bytes for 2*B*S*N*K operations (2 per byte
// at B = 8, far below the fp32 ridge): 0.642 ms at B = 8, S = 32,
// N = 131,072, K = 128 (2.15 GB).  There scripts_dev/topk_variants.py
// measures (an H100 80GB HBM3 at 700 W, passes queued back to back)
// the scoring pass at 0.708 ms, 3,035 GB/s of items, 0.91 of the bound,
// and the selection pass at 0.027 ms.  What is left of the scoring
// pass is the last tenth of the memory rate (sddmm.cu streams at 0.93
// of it).  At N = 8,192 (0.134 GB, bound 0.040 ms) scoring takes
// 0.054 ms and selection 0.022 ms: 128 scoring blocks, then one
// selecting round of 8 blocks whose histograms contend on the few bins
// the top byte of the rank words fills; chip_smoke.py adds the call's
// host work beside it.  Every offset is 64-bit.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint64_t PAD = ~0ull;   // sorts after every key

// A 32-bit key whose ascending order is the rank's DESCENDING order.
__device__ __forceinline__ uint32_t desc_key(float r) {
  uint32_t u = __float_as_uint(r);
  if ((u << 1) == 0u) u = 0u;            // -0.0 ties with +0.0
  const uint32_t ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ~ord;
}

__host__ __device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__host__ __device__ __forceinline__ int64_t lmax(int64_t a, int64_t b) {
  return a > b ? a : b;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers, TMA ----------------------------------------------------

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

// one box of a 3-d tensor map at coordinates (c0, c1, c2), innermost first
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// ---- pass 1: scoring -----------------------------------------------------

// The operand element: its box row's bytes, where chunk c (16 bytes) of
// box row r lies under the map's swizzle, and the 16 bytes of a chunk
// widened to fp32 in k order.
template <typename E>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int PER = 4;   // elements a 16-byte chunk
  static __host__ __device__ constexpr uint32_t chunk(int c, int r) {
    return (uint32_t)((c ^ (r & 7)) << 4);   // 128-byte swizzle
  }
  static __device__ __forceinline__ void wide(const unsigned char* p,
                                              float (&x)[PER]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
  static __device__ __forceinline__ float one(const unsigned char* p) {
    return *reinterpret_cast<const float*>(p);
  }
  static __device__ __forceinline__ float zero() { return 0.f; }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int PER = 8;
  static __host__ __device__ constexpr uint32_t chunk(int c, int r) {
    return (uint32_t)((c ^ ((r >> 1) & 3)) << 4);   // 64-byte swizzle
  }
  static __device__ __forceinline__ void wide(const unsigned char* p,
                                              float (&x)[PER]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ float one(const unsigned char* p) {
    return __uint_as_float((uint32_t)*reinterpret_cast<const uint16_t*>(p)
                           << 16);
  }
  static __device__ __forceinline__ __nv_bfloat16 zero() {
    return __nv_bfloat16(0.f);
  }
};

constexpr int SCORE_THREADS = 256;
constexpr int GROUP = 8;          // users a scoring block serves
constexpr int BOX = 32;           // elements of K in a box row
constexpr int STAGES = 3;   // stages in flight (TMA): 2 blocks an SM

// boxes of K a stage holds for a tile of tn items: 32 KB of items
__host__ __device__ constexpr int boxes_a_stage(int64_t tn) {
  return tn >= 256 ? 1 : (tn == 128 ? 2 : 4);
}

template <int TN, typename E>
struct Tile {
  static constexpr int SUBS = SCORE_THREADS / TN;   // threads an item
  static constexpr int UPT = GROUP / SUBS;          // users a thread
  static constexpr int NB = boxes_a_stage(TN);
  // bytes of a box row: the swizzle span (128 fp32, 64 bf16)
  static constexpr int LINE = BOX * (int)sizeof(E);
  static constexpr int CHUNKS = LINE / 16;          // 16-byte chunks a row
  static constexpr int V_BOX = TN * LINE;
  static constexpr int U_BOX = GROUP * LINE;
  // a multiple of the swizzle's period (1024 bytes fp32, 512 bf16)
  static constexpr int STAGE = NB * (V_BOX + U_BOX);
  static constexpr int smem(int stages) {
    return stages * STAGE + 1024 + 8 * stages;   // alignment, mbarriers
  }
  static_assert(GROUP % SUBS == 0, "a thread's users must divide the group");
};

struct ScoreArgs {
  const void* us;      // (B, S, K), fp32 or bf16
  const void* v;       // (S, N, K), as us
  const float* excl;   // (B, N)
  uint32_t* key;       // (B, N) outputs
  float* mean;
  float* ex2;
  int64_t B, S, N, K;
  int64_t groups;      // ceil(B / GROUP)
  int64_t kst;         // stages a sample: ceil(ceil(K / BOX) / NB)
  float inv_s;
};

// thread 0: stage i (sample i / kst, boxes of K from (i % kst) * NB) into
// the buffer at st, completing on the barrier bar
template <int TN, typename E>
__device__ __forceinline__ void issue_stage(const CUtensorMap* vm,
                                            const CUtensorMap* um,
                                            uint32_t st, uint32_t bar,
                                            int64_t i, const ScoreArgs& a,
                                            int nbox, int64_t n0,
                                            int64_t g0) {
  using T = Tile<TN, E>;
  const int s = (int)(i / a.kst);
  const int first = (int)(i % a.kst) * T::NB;
  const int nb = (int)lmin(T::NB, nbox - first);
  mbar_expect_tx(bar, (uint32_t)(nb * (T::V_BOX + T::U_BOX)));
  for (int j = 0; j < nb; ++j) {
    const int k0 = (first + j) * BOX;
    tma_load(st + j * T::V_BOX, vm, bar, k0, (int)n0, s);
    tma_load(st + T::NB * T::V_BOX + j * T::U_BOX, um, bar, k0, s, (int)g0);
  }
}

// every thread: stage i by plain loads, in the layout TMA gives
// the byte of element c (0 <= c < BOX) of box row r, under the swizzle
template <typename E>
__device__ __forceinline__ int elem_at(int r, int c) {
  constexpr int PER = Elem<E>::PER;
  return r * BOX * (int)sizeof(E) + (int)Elem<E>::chunk(c / PER, r) +
         (c % PER) * (int)sizeof(E);
}

template <int TN, typename E>
__device__ void fill_stage(unsigned char* st, int64_t i, const ScoreArgs& a,
                           int nbox, int64_t n0, int64_t g0) {
  using T = Tile<TN, E>;
  const E* v = static_cast<const E*>(a.v);
  const E* us = static_cast<const E*>(a.us);
  const int64_t s = i / a.kst;
  const int first = (int)(i % a.kst) * T::NB;
  const int nb = (int)lmin(T::NB, nbox - first);
  for (int idx = threadIdx.x; idx < nb * TN * BOX; idx += SCORE_THREADS) {
    const int j = idx / (TN * BOX), rr = idx / BOX % TN, c = idx % BOX;
    const int64_t kk = (int64_t)(first + j) * BOX + c, n = n0 + rr;
    const E x = (n < a.N && kk < a.K) ? v[(s * a.N + n) * a.K + kk]
                                      : Elem<E>::zero();
    *reinterpret_cast<E*>(st + j * T::V_BOX + elem_at<E>(rr, c)) = x;
  }
  for (int idx = threadIdx.x; idx < nb * GROUP * BOX;
       idx += SCORE_THREADS) {
    const int j = idx / (GROUP * BOX), g = idx / BOX % GROUP, c = idx % BOX;
    const int64_t kk = (int64_t)(first + j) * BOX + c, b = g0 + g;
    const E x = (b < a.B && kk < a.K) ? us[(b * a.S + s) * a.K + kk]
                                      : Elem<E>::zero();
    *reinterpret_cast<E*>(st + T::NB * T::V_BOX + j * T::U_BOX +
                          elem_at<E>(g, c)) = x;
  }
}

// chunk c (columns PER*c..PER*c+PER-1) of box j: the thread's item row
// r against its users
template <int TN, typename E>
__device__ __forceinline__ void dot_chunk(const unsigned char* st, int j,
                                          int c, int r, int u0,
                                          float (&acc)[Tile<TN, E>::UPT]) {
  using T = Tile<TN, E>;
  using X = Elem<E>;
  float x[X::PER];
  X::wide(st + j * T::V_BOX + r * T::LINE + X::chunk(c, r), x);
  const unsigned char* ub = st + T::NB * T::V_BOX + j * T::U_BOX;
#pragma unroll
  for (int g = 0; g < T::UPT; ++g) {
    const int ur = u0 + g;
    float y[X::PER];
    X::wide(ub + ur * T::LINE + X::chunk(c, ur), y);
#pragma unroll
    for (int q = 0; q < X::PER; ++q) acc[g] = fmaf(x[q], y[q], acc[g]);
  }
}

// column kk (0 <= kk < NB * BOX) of the stage
template <int TN, typename E>
__device__ __forceinline__ void dot1(const unsigned char* st, int kk, int r,
                                     int u0,
                                     float (&acc)[Tile<TN, E>::UPT]) {
  using T = Tile<TN, E>;
  const int j = kk / BOX, c = kk % BOX;
  const float x = Elem<E>::one(st + j * T::V_BOX + elem_at<E>(r, c));
  const unsigned char* ub = st + T::NB * T::V_BOX + j * T::U_BOX;
#pragma unroll
  for (int g = 0; g < T::UPT; ++g) {
    const float y = Elem<E>::one(ub + elem_at<E>(u0 + g, c));
    acc[g] = fmaf(x, y, acc[g]);
  }
}

template <int TN, bool TMA, typename E>
__global__ void __launch_bounds__(SCORE_THREADS, 1)
    score_kernel(const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap umap,
                 const ScoreArgs a) {
  using T = Tile<TN, E>;
  constexpr int PER = Elem<E>::PER;
  constexpr int NST = TMA ? STAGES : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t shift = ((raw + 1023u) & ~1023u) - raw;   // swizzle atoms
  unsigned char* sm = smem_raw + shift;
  const uint32_t base = raw + shift;
  const uint32_t bars = base + NST * T::STAGE;

  const int64_t n0 = (int64_t)(blockIdx.x / a.groups) * TN;
  const int64_t g0 = (int64_t)(blockIdx.x % a.groups) * GROUP;
  const int r = threadIdx.x % TN;
  const int u0 = threadIdx.x / TN * T::UPT;
  const int64_t total = a.S * a.kst;
  const int nbox = (int)((a.K + BOX - 1) / BOX);

  if (TMA && threadIdx.x == 0) {
    for (int i = 0; i < NST; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (TMA && threadIdx.x == 0)
    for (int64_t i = 0; i < NST && i < total; ++i)
      issue_stage<TN, E>(&vmap, &umap, base + (uint32_t)i * T::STAGE,
                         bars + 8 * (uint32_t)i, i, a, nbox, n0, g0);

  float acc[T::UPT], msum[T::UPT], qsum[T::UPT];
#pragma unroll
  for (int g = 0; g < T::UPT; ++g) acc[g] = msum[g] = qsum[g] = 0.f;

  for (int64_t i = 0; i < total; ++i) {
    const int buf = TMA ? (int)(i % NST) : 0;
    const unsigned char* st = sm + buf * T::STAGE;
    if (TMA) {
      mbar_wait(bars + 8 * buf, (uint32_t)((i / NST) & 1));
    } else {
      fill_stage<TN, E>(sm, i, a, nbox, n0, g0);
      __syncthreads();
    }
    const int64_t kb = (i % a.kst) * T::NB * BOX;
    const int width = (int)(lmin(a.K, kb + T::NB * BOX) - kb);
    if (width == T::NB * BOX) {
#pragma unroll
      for (int j = 0; j < T::NB; ++j) {
#pragma unroll
        for (int c = 0; c < T::CHUNKS; ++c)
          dot_chunk<TN, E>(st, j, c, r, u0, acc);
      }
    } else {
      int kk = 0;
      for (; kk + PER <= width; kk += PER)
        dot_chunk<TN, E>(st, kk / BOX, kk % BOX / PER, r, u0, acc);
      for (; kk < width; ++kk) dot1<TN, E>(st, kk, r, u0, acc);
    }
    if (kb + width == a.K) {   // the sample's last stage
#pragma unroll
      for (int g = 0; g < T::UPT; ++g) {
        msum[g] += acc[g];
        qsum[g] = fmaf(acc[g], acc[g], qsum[g]);
        acc[g] = 0.f;
      }
    }
    __syncthreads();   // every thread is done with the buffer
    if (TMA && threadIdx.x == 0 && i + NST < total)
      issue_stage<TN, E>(&vmap, &umap, base + buf * T::STAGE,
                         bars + 8 * buf, i + NST, a, nbox, n0, g0);
  }

  const int64_t n = n0 + r;
  if (n >= a.N) return;
#pragma unroll
  for (int g = 0; g < T::UPT; ++g) {
    const int64_t b = g0 + u0 + g;
    if (b < a.B) {
      const int64_t o = b * a.N + n;
      const float mean = msum[g] * a.inv_s;
      const float rank = a.excl[o] > 0.f ? __uint_as_float(0xff800000u)
                                         : mean;   // -inf
      a.key[o] = desc_key(rank);
      a.mean[o] = mean;
      a.ex2[o] = qsum[g] * a.inv_s;
    }
  }
}

// ---- pass 2: selection ---------------------------------------------------

constexpr int SORT_THREADS = 1024;
constexpr int SORT_CAP = 4096;     // keys a sorting block holds
constexpr int SEGMENT = 8192;      // keys a selecting block holds
constexpr int SELECT_CAP = 1024;   // largest k of the chunk route
constexpr int MERGE_THREADS = 256;

// The outputs, and the scoring pass's mean and ex2 they are gathered from.
struct Emit {
  int32_t* ids;        // (B, k)
  float* mean;
  float* ex2;
  const float* smean;  // (B, N)
  const float* sex2;
  int64_t N, k;
};

__device__ __forceinline__ void emit(const Emit& e, int64_t b, int64_t r,
                                     uint64_t key) {
  const int64_t o = b * e.k + r;
  if (key == PAD) {
    e.ids[o] = -1;
    e.mean[o] = 0.f;
    e.ex2[o] = 0.f;
    return;
  }
  const int64_t id = (uint32_t)key;
  e.ids[o] = (int32_t)id;
  e.mean[o] = e.smean[b * e.N + id];
  e.ex2[o] = e.sex2[b * e.N + id];
}

// Ascending bitonic sort of n keys (a power of 2) in shared memory, by
// every thread of the block; the caller synchronises before it.
__device__ void bitonic_sort(uint64_t* a, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < n / 2; i += blockDim.x) {
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

__device__ __forceinline__ int64_t warp_exclusive_scan(int64_t x,
                                                       int lane) {
  int64_t incl = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int64_t t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  return incl - x;
}

// A segment's 64-bit keys: one user's items [base, base + n) from the
// scoring pass's rank words (the id in the low word), or keys in memory.
struct ScoreKeys {
  const uint32_t* key;
  int64_t base;
  __device__ __forceinline__ uint64_t operator()(int64_t i) const {
    return ((uint64_t)key[i] << 32) | (uint32_t)(base + i);
  }
};

struct Keys64 {
  const uint64_t* key;
  __device__ __forceinline__ uint64_t operator()(int64_t i) const {
    return key[i];
  }
};

struct Out64 {
  uint64_t* key;
  __device__ __forceinline__ void operator()(int64_t i, uint64_t x) const {
    key[i] = x;
  }
};

struct RadixShared {
  uint32_t hist[256];
  uint32_t prefix;
  int64_t rem;
  int64_t w_lt[32], w_eq[32], eq_base[32], take_base[32];
};

// Every thread of the block: the k smallest of the n keys src(0..n-1)
// (1 <= k <= n), in position order, to dst(0..k-1).  Radix select of the
// k-th smallest rank word T (the key's high word; 8-bit digits, one
// histogram a digit), then every key whose rank word is below T and, of
// those at T, the first in position order.  Positions rise with item
// ids in every segment this kernel is given, so ties go to the lowest
// id.  Integer counts only: the answer does not depend on the order in
// which the threads count.
template <class Src, class Dst>
__device__ void select_k(const Src& src, int64_t n, int64_t k,
                         const Dst& dst, RadixShared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const uint32_t full = 0xffffffffu;
  uint32_t prefix = 0, pmask = 0;
  int64_t rem = k;   // rank of the wanted word among those matching prefix
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) sh.hist[i] = 0;
    __syncthreads();
    for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
      const uint32_t x = (uint32_t)(src(i) >> 32);
      if ((x & pmask) == prefix) atomicAdd(&sh.hist[(x >> shift) & 255u], 1u);
    }
    __syncthreads();
    if (warp == 0) {
      uint32_t c[8];
      int64_t sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = sh.hist[lane * 8 + j];
        sum += c[j];
      }
      const int64_t before = warp_exclusive_scan(sum, lane);
      if (before < rem && rem <= before + sum) {
        int64_t run = before;
        int j = 0;
        while (run + c[j] < rem) run += c[j++];
        sh.prefix = prefix | ((uint32_t)(lane * 8 + j) << shift);
        sh.rem = rem - run;
      }
    }
    __syncthreads();
    prefix = sh.prefix;
    rem = sh.rem;
    pmask |= 255u << shift;
  }
  const uint32_t T = prefix;
  const int64_t need = rem;   // words == T to take, first positions first

  // each warp walks a contiguous run of positions, 32 at a time
  const int64_t seg = ((n + warps - 1) / warps + 31) / 32 * 32;
  const int64_t start = warp * seg, end = lmin(start + seg, n);
  int64_t lt = 0, eq = 0;
  for (int64_t i0 = start; i0 < end; i0 += 32) {
    const int64_t i = i0 + lane;
    const bool ok = i < end;
    const uint32_t x = ok ? (uint32_t)(src(i) >> 32) : 0u;
    lt += __popc(__ballot_sync(full, ok && x < T));
    eq += __popc(__ballot_sync(full, ok && x == T));
  }
  if (lane == 0) {
    sh.w_lt[warp] = lt;
    sh.w_eq[warp] = eq;
  }
  __syncthreads();
  if (warp == 0) {
    const int64_t e = lane < warps ? sh.w_eq[lane] : 0;
    const int64_t l = lane < warps ? sh.w_lt[lane] : 0;
    const int64_t eb = warp_exclusive_scan(e, lane);
    const int64_t te = lmax(0, lmin(e, need - eb));
    sh.eq_base[lane] = eb;
    sh.take_base[lane] = warp_exclusive_scan(l + te, lane);
  }
  __syncthreads();
  int64_t er = sh.eq_base[warp], tr = sh.take_base[warp];
  const uint32_t below = (1u << lane) - 1u;
  for (int64_t i0 = start; i0 < end; i0 += 32) {
    const int64_t i = i0 + lane;
    const bool ok = i < end;
    const uint64_t key = ok ? src(i) : PAD;
    const uint32_t x = (uint32_t)(key >> 32);
    const bool is_eq = ok && x == T;
    const uint32_t eb = __ballot_sync(full, is_eq);
    const bool take =
        (ok && x < T) || (is_eq && er + __popc(eb & below) < need);
    const uint32_t tb = __ballot_sync(full, take);
    if (take) dst(tr + __popc(tb & below), key);
    er += __popc(eb);
    tr += __popc(tb);
  }
  __syncthreads();
}

// Selection for k <= 1,024, in rounds.  Block (b, g): the k best keys of
// segment g of user b -- items [g*width, (g+1)*width) of the scoring pass
// (SCORES) or lists [g*width, (g+1)*width) of the previous round's L_in
// -- in id order to list g of out (B, L_out, k); on the last round
// (L_out == 1) sorted (bitonic, in shared memory) into the outputs.
// Shared memory: SEGMENT keys of the segment, then kp >= k survivors.
template <bool SCORES>
__global__ void __launch_bounds__(SORT_THREADS)
    select_kernel(const uint32_t* __restrict__ keys,
                  const uint64_t* __restrict__ in, int64_t L_in,
                  int64_t width, uint64_t* out, int64_t L_out, int kp,
                  Emit e) {
  extern __shared__ uint64_t skey[];
  __shared__ RadixShared sh;
  uint64_t* surv = skey + SEGMENT;
  const int64_t b = blockIdx.x / L_out, g = blockIdx.x % L_out;
  int64_t n;
  if (SCORES) {
    const int64_t base = g * width;
    n = lmin(width, e.N - base);
    const ScoreKeys src{keys + b * e.N + base, base};
    for (int i = threadIdx.x; i < n; i += SORT_THREADS) skey[i] = src(i);
  } else {
    const int64_t first = g * width;
    n = lmin(width, L_in - first) * e.k;
    const uint64_t* src = in + (b * L_in + first) * e.k;
    for (int i = threadIdx.x; i < n; i += SORT_THREADS) skey[i] = src[i];
  }
  for (int i = threadIdx.x; i < kp; i += SORT_THREADS) surv[i] = PAD;
  __syncthreads();
  if (n <= e.k) {
    for (int i = threadIdx.x; i < n; i += SORT_THREADS) surv[i] = skey[i];
    __syncthreads();
  } else {
    select_k(Keys64{skey}, n, e.k, Out64{surv}, sh);
  }
  if (L_out == 1) {
    bitonic_sort(surv, kp);
    for (int r = threadIdx.x; r < e.k; r += SORT_THREADS)
      emit(e, b, r, surv[r]);
  } else {
    for (int r = threadIdx.x; r < e.k; r += SORT_THREADS)
      out[(b * L_out + g) * e.k + r] = surv[r];
  }
}

// Selection for k > 1,024, first step.  Block b: user b's k best keys, in
// id order, to surv (B, k).
__global__ void __launch_bounds__(SORT_THREADS)
    radix_kernel(const uint32_t* __restrict__ key, int64_t N, int64_t k,
                 uint64_t* surv) {
  __shared__ RadixShared sh;
  const int64_t b = blockIdx.x;
  select_k(ScoreKeys{key + b * N, 0}, N, k, Out64{surv + b * k}, sh);
}

// block (b, t): sorts keys [t*SORT_CAP, (t+1)*SORT_CAP) of user b's k in
// place (n: a power of 2 >= their count), or into the outputs when
// they are all of them
__global__ void __launch_bounds__(SORT_THREADS)
    tile_sort_kernel(uint64_t* runs, int64_t tiles, int n, Emit e) {
  extern __shared__ uint64_t skey[];
  const int64_t b = blockIdx.x / tiles;
  const int64_t lo = (blockIdx.x % tiles) * SORT_CAP;
  const int64_t len = lmin(SORT_CAP, e.k - lo);
  uint64_t* run = runs + b * e.k + lo;
  for (int i = threadIdx.x; i < n; i += SORT_THREADS)
    skey[i] = i < len ? run[i] : PAD;
  __syncthreads();
  bitonic_sort(skey, n);
  for (int i = threadIdx.x; i < len; i += SORT_THREADS) {
    if (tiles == 1)
      emit(e, b, lo + i, skey[i]);
    else
      run[i] = skey[i];
  }
}

// one thread a key: sorted runs of width w of each user's k keys merged
// in pairs into runs of 2w, each key placed by counting the keys of the
// other run before it; into the outputs on the last round
__global__ void __launch_bounds__(MERGE_THREADS)
    merge_pass_kernel(const uint64_t* __restrict__ in, uint64_t* out,
                      int64_t B, int64_t w, Emit e, int last) {
  const int64_t t = (int64_t)blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (t >= B * e.k) return;
  const int64_t b = t / e.k, i = t % e.k;
  const int64_t lo = i / (2 * w) * (2 * w);
  const int64_t mid = lmin(lo + w, e.k), hi = lmin(lo + 2 * w, e.k);
  const uint64_t* run = in + b * e.k;
  const uint64_t x = run[i];
  int64_t pos;
  if (i < mid) {   // the left run's keys go before equal right ones
    int64_t p = mid, q = hi;
    while (p < q) {
      const int64_t m = (p + q) / 2;
      if (run[m] < x) p = m + 1; else q = m;
    }
    pos = lo + (i - lo) + (p - mid);
  } else {
    int64_t p = lo, q = mid;
    while (p < q) {
      const int64_t m = (p + q) / 2;
      if (run[m] <= x) p = m + 1; else q = m;
    }
    pos = lo + (i - mid) + (p - lo);
  }
  if (last)
    emit(e, b, pos, x);
  else
    out[b * e.k + pos] = x;
}

// ---- host ----------------------------------------------------------------

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

// a packed (d2, d1, d0) array of E as a 3-d map, boxes of BOX x box1 x
// box2 (a box row BOX elements: 128 bytes fp32 with the 128-byte
// swizzle, 64 bytes bf16 with the 64-byte one), zeros outside the array
template <typename E>
CUresult make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr,
                  int64_t d0, int64_t d1, int64_t d2, uint32_t box1,
                  uint32_t box2) {
  constexpr bool F32 = sizeof(E) == 4;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1,
                              (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)(d0 * sizeof(E)),
                                 (cuuint64_t)(d0 * d1 * sizeof(E))};
  const cuuint32_t box[3] = {BOX, box1, box2};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map,
             F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             3, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             F32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int TN, bool TMA, typename E>
cudaError_t launch_score(const CUtensorMap& vm, const CUtensorMap& um,
                         const ScoreArgs& a, int64_t blocks,
                         cudaStream_t st) {
  const int bytes = Tile<TN, E>::smem(TMA ? STAGES : 1);
  cudaError_t err = cudaFuncSetAttribute(
      score_kernel<TN, TMA, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  score_kernel<TN, TMA, E><<<(unsigned)blocks, SCORE_THREADS, bytes, st>>>(
      vm, um, a);
  return cudaGetLastError();
}

template <int TN, typename E>
cudaError_t launch_score(bool tma, const CUtensorMap& vm,
                         const CUtensorMap& um, const ScoreArgs& a,
                         int64_t blocks, cudaStream_t st) {
  return tma ? launch_score<TN, true, E>(vm, um, a, blocks, st)
             : launch_score<TN, false, E>(vm, um, a, blocks, st);
}

int64_t align256(int64_t bytes) { return (bytes + 255) / 256 * 256; }

int pow2_at_least(int64_t n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

constexpr int64_t MAX_GRID = 0x7fffffff;

template <typename E>
int run(const void* us, const void* v, const void* excl, void* ids,
        void* mean, void* ex2, void* scratch, int64_t scratch_bytes,
        int64_t B, int64_t S, int64_t N, int64_t K, int64_t k, int64_t tn,
        int64_t chunk, int64_t group, int tma, int passes, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (k < 1 || k > N || S < 1 || K < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool small_k = k <= SELECT_CAP;
  const int64_t L = small_k ? (N + chunk - 1) / chunk : 1;
  const int64_t runs = B * L * k;   // 64-bit keys in a set of runs
  unsigned char* p = static_cast<unsigned char*>(scratch);
  uint32_t* keys = reinterpret_cast<uint32_t*>(p);
  p += align256(4 * B * N);
  float* smean = reinterpret_cast<float*>(p);
  p += align256(4 * B * N);
  float* sex2 = reinterpret_cast<float*>(p);
  p += align256(4 * B * N);
  uint64_t* cur = reinterpret_cast<uint64_t*>(p);
  p += align256(8 * runs);
  uint64_t* other = reinterpret_cast<uint64_t*>(p);
  p += align256(8 * runs);
  if (p - static_cast<unsigned char*>(scratch) > scratch_bytes)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;

  if (passes & 1) {
    const int nb = boxes_a_stage(tn);
    ScoreArgs a;
    a.us = us;
    a.v = v;
    a.excl = static_cast<const float*>(excl);
    a.key = keys;
    a.mean = smean;
    a.ex2 = sex2;
    a.B = B;
    a.S = S;
    a.N = N;
    a.K = K;
    a.groups = (B + GROUP - 1) / GROUP;
    a.kst = ((K + BOX - 1) / BOX + nb - 1) / nb;
    a.inv_s = 1.0f / (float)S;
    const int64_t blocks = a.groups * ((N + tn - 1) / tn);
    if (blocks > MAX_GRID) return (int)cudaErrorInvalidConfiguration;
    CUtensorMap vm = {}, um = {};
    if (tma) {
      EncodeTiled enc = encoder();
      if (enc == nullptr) return 999;
      CUresult r = make_map<E>(enc, &vm, v, K, N, S, (uint32_t)tn, 1);
      if (r == CUDA_SUCCESS)
        r = make_map<E>(enc, &um, us, K, S, B, 1, GROUP);
      if (r != CUDA_SUCCESS) return 1000 + (int)r;
    }
    switch (tn) {
      case 256:
        err = launch_score<256, E>(tma, vm, um, a, blocks, st);
        break;
      case 128:
        err = launch_score<128, E>(tma, vm, um, a, blocks, st);
        break;
      case 64:
        err = launch_score<64, E>(tma, vm, um, a, blocks, st);
        break;
      case 32:
        err = launch_score<32, E>(tma, vm, um, a, blocks, st);
        break;
      default: return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
  }
  if (!(passes & 2)) return (int)cudaSuccess;

  const Emit e{static_cast<int32_t*>(ids), static_cast<float*>(mean),
               static_cast<float*>(ex2), smean, sex2, N, k};
  if (small_k) {
    if (chunk < k || chunk > SEGMENT || group * k > SEGMENT || group < 2)
      return (int)cudaErrorInvalidValue;
    if (B * L > MAX_GRID) return (int)cudaErrorInvalidConfiguration;
    const int kp = pow2_at_least(k);
    const int smem = (SEGMENT + kp) * (int)sizeof(uint64_t);
    err = cudaFuncSetAttribute(select_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(select_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
    if (err != cudaSuccess) return (int)err;
    select_kernel<true><<<(unsigned)(B * L), SORT_THREADS, smem, st>>>(
        keys, nullptr, 0, chunk, cur, L, kp, e);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    for (int64_t l = L; l > 1;) {
      const int64_t l_out = (l + group - 1) / group;
      select_kernel<false><<<(unsigned)(B * l_out), SORT_THREADS, smem,
                             st>>>(nullptr, cur, l, group, other, l_out,
                                   kp, e);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      uint64_t* t = cur;
      cur = other;
      other = t;
      l = l_out;
    }
    return (int)cudaSuccess;
  }

  const int64_t tiles = (k + SORT_CAP - 1) / SORT_CAP;
  if (B * tiles > MAX_GRID ||
      (B * k + MERGE_THREADS - 1) / MERGE_THREADS > MAX_GRID)
    return (int)cudaErrorInvalidConfiguration;
  radix_kernel<<<(unsigned)B, SORT_THREADS, 0, st>>>(keys, N, k, cur);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = pow2_at_least(lmin(SORT_CAP, k));
  tile_sort_kernel<<<(unsigned)(B * tiles), SORT_THREADS,
                     (size_t)n * sizeof(uint64_t), st>>>(cur, tiles, n, e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int64_t w = SORT_CAP; w < k; w *= 2) {
    merge_pass_kernel<<<(unsigned)((B * k + MERGE_THREADS - 1) /
                                   MERGE_THREADS),
                        MERGE_THREADS, 0, st>>>(cur, other, B, w, e,
                                                2 * w >= k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    uint64_t* t = cur;
    cur = other;
    other = t;
  }
  return (int)cudaSuccess;
}

}  // namespace

// us (B, S, K), v (S, N, K), excl (B, N) fp32, contiguous ->
// ids (B, k) int32, mean (B, k), ex2 (B, k) fp32, for 1 <= k <= N.
// tn: items a scoring block scores (32, 64, 128 or 256); chunk: items a
// chunk block sorts (k <= 1024; a power of 2 >= k, <= 4096); group:
// lists a merge block folds (group * k <= 4096).  tma != 0 promises
// K % 4 == 0 and 16-byte aligned us and v.  passes: 1 scoring, 2
// selection (over the scratch a scoring pass left), 3 both.  scratch:
// scratch_bytes of device memory, laid out as (B, N) rank keys, means,
// ex2, then two sets of sorted runs (B, lists, k) of 64-bit keys, each
// part 256-byte aligned.  Returns the first cudaError_t of the
// launches; 1000 + the CUresult of a tensor map that did not encode;
// 999 when the driver has no cuTensorMapEncodeTiled.
extern "C" int topk_score_f32(const void* us, const void* v,
                              const void* excl, void* ids, void* mean,
                              void* ex2, void* scratch,
                              int64_t scratch_bytes, int64_t B, int64_t S,
                              int64_t N, int64_t K, int64_t k, int64_t tn,
                              int64_t chunk, int64_t group, int tma,
                              int passes, void* stream) {
  return run<float>(us, v, excl, ids, mean, ex2, scratch, scratch_bytes, B,
                    S, N, K, k, tn, chunk, group, tma, passes, stream);
}

// The same with bf16 us and v (excl and the outputs as above); tma != 0
// promises K % 8 == 0 and 16-byte aligned us and v.
extern "C" int topk_score_bf16(const void* us, const void* v,
                               const void* excl, void* ids, void* mean,
                               void* ex2, void* scratch,
                               int64_t scratch_bytes, int64_t B, int64_t S,
                               int64_t N, int64_t K, int64_t k, int64_t tn,
                               int64_t chunk, int64_t group, int tma,
                               int passes, void* stream) {
  return run<__nv_bfloat16>(us, v, excl, ids, mean, ex2, scratch,
                            scratch_bytes, B, S, N, K, k, tn, chunk, group,
                            tma, passes, stream);
}
