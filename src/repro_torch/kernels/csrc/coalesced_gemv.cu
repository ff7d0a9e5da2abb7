// Coalesced matrix-vector superkernel for Hopper (sm_90a), fp32 and bf16.
//
// Replaces the Pallas TPU kernel `coalesced_gemv` of the JAX package
// (src/repro/kernels/coalesced_gemv.py). Same function: G matvecs, each
// with its own weight, run as ONE launch: out[g] = x[g] @ w[g] for
// x [G, K], w [G, K, N], out [G, N]. The products are accumulated in fp32
// with IEEE fp32 FMAs (CUDA cores, so no TF32) and stored in x's dtype.
//
// What bounds it: each weight element is read once and feeds one FMA, so
// the kernel is bound by the bytes of w — far below the card's
// operations-per-byte ridge. What it needs is every SM streaming w from the
// first microsecond to the last, at every G, with nothing serial around the
// stream:
//
//   * a block owns (K rank, column tile, g): the tile is kRowLanes * 16
//     bytes of output columns (32 in fp32, 64 in bf16), the rank a share of
//     K. The S ranks of one (column tile, g) are the blocks of one thread
//     block cluster: grid = (S, N / tile, G). S comes from the wrapper
//     (kernels/coalesced_gemv.py, `k_split`) and is a function of K alone,
//     so small-G launches still hold several blocks an SM;
//   * the block's threads form kRowGroups row groups of kRowLanes lanes;
//     each lane of a group loads 16 neighbouring bytes of one k row (a
//     group reads one 128-byte line of the row). K is cut into rounds of
//     kRowGroups rows, one row a group; rank q takes rounds q, q + S,
//     q + 2S, ..., so the ranks of a cluster stream neighbouring rows (on
//     the H100 that beat contiguous K ranges a rank), their shares differ
//     by at most one round, and every w element is read exactly once. A
//     thread starts kUnroll loads of w, and of the kUnroll elements of x
//     they meet, before its first FMA. x is read straight through the read-only
//     path (8 lanes of a group read one element: one broadcast), so no
//     barrier stands between the launch and the first bytes of w;
//   * a row group's partial sums are added across the groups of a warp by
//     shuffles (a fixed tree), then across the block's warps in warp order
//     through shared memory;
//   * split-K without a workspace: rank q owns output columns q, q + S, ...
//     of the tile. Each block writes its partial of every column into the
//     owner's shared memory (distributed shared memory, one inbox row per
//     sending rank); after the cluster's barrier (release / acquire) rank q
//     adds its columns' S partials in rank order 0 .. S - 1 from its own
//     shared memory and stores them. No block touches another's shared
//     memory after that barrier, so none has to wait for another's reads
//     before it leaves; a first barrier phase, arrived at when the block
//     starts and waited on just before the remote writes, makes sure every
//     block of the cluster is running before its shared memory is written.
//     One launch, no atomics: the same inputs give bitwise the same output
//     on every call, and a problem's output does not depend on what else
//     was coalesced with it.
//
// w is indexed with 64-bit offsets. Any K from 1 to 2^30 - 1 is taken (the
// last round and the last batch of loads are guarded; below 2^30 the row
// indices stay in int); N must be a multiple of the column tile (the
// wrapper's launch guard checks both).
//
// Bound with ctypes (plain C entry points below); the launch goes on the
// caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(GV_THREADS) || !defined(GV_ROW_LANES) || !defined(GV_UNROLL) || \
    !defined(GV_MAX_CLUSTER)
#error "the geometry comes from repro_torch/kernels/coalesced_gemv.py (-D)"
#endif

namespace {

constexpr int kThreads = GV_THREADS;
constexpr int kRowLanes = GV_ROW_LANES;     // lanes that share one k row
constexpr int kUnroll = GV_UNROLL;          // loads of w in flight a thread
constexpr int kMaxCluster = GV_MAX_CLUSTER;
constexpr int kWarps = kThreads / 32;
constexpr int kRowGroups = kThreads / kRowLanes;
constexpr int kMaxTileN = kRowLanes * 8;    // bf16: 8 elements per 16 bytes

static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps");
static_assert(32 % kRowLanes == 0,
              "a warp holds a power-of-two count of whole row groups");
static_assert(kUnroll >= 1, "at least one load in flight");
static_assert(kThreads >= kMaxTileN, "a thread for every column of a tile");
static_assert(kMaxCluster >= 1 && kMaxCluster <= 8,
              "at most 8 blocks a cluster (the portable limit)");
static_assert(sizeof(float) * (kWarps + kMaxCluster) * kMaxTileN <= 48 * 1024,
              "static shared memory of one block");

// 16 bytes of w through the read-only path, not allocated in L1 (each
// byte of w is read once)
__device__ __forceinline__ uint4 load_w(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ float load_x(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_x(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// 16 loaded bytes widened to fp32: 4 fp32, or 8 bf16 (bf16 -> fp32 is
// exact: the bf16 bits are the high half of the fp32 word)
template <typename T>
__device__ __forceinline__ void widen(uint4 t, float* v) {
  const uint32_t words[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      v[i] = __uint_as_float(words[i]);
    } else {
      v[2 * i] = __uint_as_float(words[i] << 16);
      v[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    }
  }
}

// the cluster's barrier, split into its arrive and wait halves
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// *p = v in the shared memory of the cluster's block `rank` (p is the
// address of the same variable in this block's shared memory)
__device__ __forceinline__ void store_remote(float* p, int rank, float v) {
  const uint32_t local = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(local), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(v)
               : "memory");
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gemv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                T* __restrict__ out, int K, int N) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kTileN = kRowLanes * kVec;
  __shared__ float warp_part[kWarps][kTileN];
  __shared__ float inbox[kMaxCluster][kTileN];   // [sending rank][column]

  cluster_arrive_relaxed();               // this block is running
  const int rank = blockIdx.x;            // the cluster spans grid x
  const int ranks = gridDim.x;
  const int n0 = blockIdx.y * kTileN;
  const int64_t g = blockIdx.z;
  const int tid = threadIdx.x;
  const int group = tid / kRowLanes;
  const int lane = tid % kRowLanes;
  const int rounds = (K + kRowGroups - 1) / kRowGroups;
  const T* xg = x + g * K;
  const T* wg = w + g * static_cast<int64_t>(K) * N + n0 + lane * kVec;

  float acc[kVec];
#pragma unroll
  for (int c = 0; c < kVec; ++c) acc[c] = 0.0f;

  // the rank's rounds m = rank, rank + S, ..., in order; row group r takes
  // row m * kRowGroups + r of each. Every load of a batch starts before the
  // batch's first FMA
  for (int m0 = rank; m0 < rounds; m0 += ranks * kUnroll) {
    uint4 wv[kUnroll];
    float xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = (m0 + u * ranks) * kRowGroups + group;
      if (k < K) {
        wv[u] = load_w(wg + static_cast<int64_t>(k) * N);
        xv[u] = load_x(xg + k);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if ((m0 + u * ranks) * kRowGroups + group < K) {
        float v[kVec];
        widen<T>(wv[u], v);
#pragma unroll
        for (int c = 0; c < kVec; ++c) acc[c] = fmaf(xv[u], v[c], acc[c]);
      }
    }
  }

  // the row groups of a warp: a shuffle tree over the lanes that share
  // `lane` ((r0 + r1) + (r2 + r3) for four groups a warp); every lane ends
  // with the warp's sum
#pragma unroll
  for (int off = kRowLanes; off < 32; off *= 2) {
#pragma unroll
    for (int c = 0; c < kVec; ++c)
      acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
  }
  const int warp = tid / 32;
  if (tid % 32 < kRowLanes) {
#pragma unroll
    for (int c = 0; c < kVec; ++c) warp_part[warp][lane * kVec + c] = acc[c];
  }
  __syncthreads();
  // the block's warps in warp order: the block's partial of column tid,
  // written into the inbox of the column's owner (rank tid mod S)
  float sum = 0.0f;
  if (tid < kTileN) {
    sum = warp_part[0][tid];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) sum += warp_part[i][tid];
  }
  cluster_wait_acquire();                 // every block of the cluster runs
  if (tid < kTileN) store_remote(&inbox[rank][tid], tid % ranks, sum);
  cluster_arrive_release();
  cluster_wait_acquire();                 // every partial has arrived
  // rank q adds columns q, q + S, ... of all S partials, in rank order
  const int c = rank + tid * ranks;
  if (c < kTileN) {
    float total = inbox[0][c];
    for (int p = 1; p < ranks; ++p) total += inbox[p][c];
    store(out + g * N + n0 + c, total);
  }
}

cudaLaunchAttribute cluster_attribute(int cluster) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  return attr;
}

template <typename T>
int launch(const void* x, const void* w, void* out, int G, int K, int N,
           int cluster, cudaStream_t stream) {
  constexpr int kTileN = kRowLanes * (16 / static_cast<int>(sizeof(T)));
  // every rank has rows
  if (cluster < 1 || cluster > kMaxCluster ||
      cluster > (K + kRowGroups - 1) / kRowGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr = cluster_attribute(cluster);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, N / kTileN, G);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, gemv_kernel<T>, static_cast<const T*>(x),
      static_cast<const T*>(w), static_cast<T*>(out), K, N);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int occupancy(int cluster, int* blocks_per_sm, int* clusters) {
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, gemv_kernel<T>, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr = cluster_attribute(cluster);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(clusters, gemv_kernel<T>, &cfg));
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; cluster: the K split (blocks of one
// cluster, the wrapper's `k_split`). Returns a cudaError_t (0 = launched).
int coalesced_gemv_launch(const void* x, const void* w, void* out, int G,
                          int K, int N, int dtype, int cluster,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, out, G, K, N, cluster, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, out, G, K, N, cluster, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of one instance an SM holds, and clusters of `cluster` blocks the
// card holds at once (cudaOccupancy*). Returns a cudaError_t.
int coalesced_gemv_occupancy(int dtype, int cluster, int* blocks_per_sm,
                             int* clusters) {
  if (dtype == 0) return occupancy<float>(cluster, blocks_per_sm, clusters);
  if (dtype == 1)
    return occupancy<__nv_bfloat16>(cluster, blocks_per_sm, clusters);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* coalesced_gemv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
