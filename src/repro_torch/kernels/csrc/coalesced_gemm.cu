// Grouped GEMM superkernel for Hopper (sm_90a), fp32 and bf16.
//
// Replaces the Pallas TPU kernel `coalesced_gemm` of the JAX package
// (src/repro/kernels/coalesced_gemm.py). Same function: A [M, K] holds G
// problems concatenated along m, each padded to a multiple of `bm` rows;
// B [G, K, N] holds the per-problem weight envelopes; gid [M / bm] (int32,
// on the device) names the problem of each bm-row m-tile. Row r of the
// result is A[r, :] @ B[gid[r / bm]], accumulated in fp32 with IEEE fp32
// FMAs (no tensor cores, so no TF32) and stored in A's dtype. Pad rows of
// A are zero, so they come back zero.
//
// What bounds it: on the serving path m is a decode batch (a few rows per
// problem), so every weight byte read feeds 2·rows FLOPs — far below the
// card's operations-per-byte ridge. The kernel is bound by the bytes of B it
// streams. The design therefore spreads the B read over as many threads as
// possible and reads every B element once per 8-row chunk:
//
//   * a block owns 8 rows of A (kRows), 128 output columns (kBlockN) and one
//     256-deep slice of K (kChunkK): grid = (M / 8, N / 128, ceil(K / 256));
//     the K split puts thousands of blocks in flight even for one decode
//     problem;
//   * the 8 rows lie in one packer m-tile (the wrapper requires bm % 8 == 0),
//     so the block reads one B[g], g = gid[row0 / bm];
//   * the A chunk is staged once in shared memory as fp32; each of the 8
//     warps walks every 8th k row of the B slice, each lane loading 4
//     neighbouring columns (16 B fp32 / 8 B bf16, a fully coalesced warp
//     read) and doing 8 x 4 FMAs against broadcast A values;
//   * the 8 warps' partial sums are added in a fixed order in shared memory
//     and written per K slice to an fp32 workspace; a second kernel adds the
//     slices in a fixed order and casts. The result is deterministic.
//
// Row chunks run fastest in the grid (blockIdx.x), so blocks that share a B
// panel (several row chunks of one prefill problem) run together and meet
// in L2. B is indexed with 64-bit offsets: a packed vocabulary projection
// [G, 4096, 65536] passes 2^31 elements at G = 8.
//
// Bound with ctypes (plain C entry points below); the launch goes on the
// caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(CG_ROWS) || !defined(CG_BLOCK_N) || !defined(CG_CHUNK_K) || \
    !defined(CG_THREADS) || !defined(CG_REDUCE_THREADS)
#error "the geometry comes from repro_torch/kernels/coalesced_gemm.py (-D)"
#endif

namespace {

// The geometry is the wrapper's (kernels/coalesced_gemm.py): it passes it
// here as -D defines and sizes its launch guard from the same values. What
// this code needs of it is checked below, when it is built.
constexpr int kRows = CG_ROWS;
constexpr int kBlockN = CG_BLOCK_N;
constexpr int kChunkK = CG_CHUNK_K;
constexpr int kThreads = CG_THREADS;
constexpr int kReduceThreads = CG_REDUCE_THREADS;
constexpr int kLaneCols = 4;  // load4 reads 4 neighbouring columns
constexpr int kWarps = kThreads / 32;

static_assert(kBlockN == 32 * kLaneCols, "one warp spans a block's columns");
static_assert(kThreads % 32 == 0 && kThreads <= 1024 && kReduceThreads <= 1024,
              "whole warps, at most 1024 threads a block");
static_assert(sizeof(float) * (kRows * kChunkK + kWarps * kRows * kBlockN) <=
                  48 * 1024,
              "static shared memory of one block");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void load4(const float* p, float v[kLaneCols]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float v[kLaneCols]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    partial_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   const int32_t* __restrict__ gid, float* __restrict__ part,
                   int M, int K, int N, int bm) {
  __shared__ float a_s[kRows][kChunkK];
  __shared__ __align__(16) float red[kWarps][kRows][kBlockN];

  const int row0 = blockIdx.x * kRows;
  const int n0 = blockIdx.y * kBlockN;
  const int slice = blockIdx.z;
  const int k0 = slice * kChunkK;
  const int kn = min(kChunkK, K - k0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int64_t g = gid[row0 / bm];

  for (int i = tid; i < kRows * kChunkK; i += kThreads) {
    const int r = i / kChunkK;
    const int kk = i % kChunkK;
    a_s[r][kk] = kk < kn
        ? to_float(a[static_cast<int64_t>(row0 + r) * K + k0 + kk])
        : 0.0f;
  }
  __syncthreads();

  float acc[kRows][kLaneCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kLaneCols; ++c) acc[r][c] = 0.0f;

  const T* bp = b + (g * K + k0) * static_cast<int64_t>(N) + n0 +
                lane * kLaneCols;
#pragma unroll 4
  for (int kk = warp; kk < kn; kk += kWarps) {
    float bv[kLaneCols];
    load4(bp + static_cast<int64_t>(kk) * N, bv);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float av = a_s[r][kk];
#pragma unroll
      for (int c = 0; c < kLaneCols; ++c) acc[r][c] = fmaf(av, bv[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r)
    *reinterpret_cast<float4*>(&red[warp][r][lane * kLaneCols]) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();

  for (int i = tid; i < kRows * kBlockN; i += kThreads) {
    const int r = i / kBlockN;
    const int c = i % kBlockN;
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[w][r][c];
    part[(static_cast<int64_t>(slice) * M + row0 + r) * N + n0 + c] = sum;
  }
}

template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
    reduce_kernel(const float* __restrict__ part, T* __restrict__ out,
                  int64_t mn, int slices) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kReduceThreads +
                    threadIdx.x;
  if (i >= mn) return;
  float sum = 0.0f;
  for (int s = 0; s < slices; ++s) sum += part[s * mn + i];
  store(out + i, sum);
}

template <typename T>
int launch(const void* a, const void* b, const void* gid, void* part,
           void* out, int M, int K, int N, int bm, cudaStream_t stream) {
  const int slices = (K + kChunkK - 1) / kChunkK;
  const dim3 grid(M / kRows, N / kBlockN, slices);
  partial_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const int32_t*>(gid), static_cast<float*>(part), M, K, N,
      bm);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t mn = static_cast<int64_t>(M) * N;
  const unsigned blocks =
      static_cast<unsigned>((mn + kReduceThreads - 1) / kReduceThreads);
  reduce_kernel<T><<<blocks, kReduceThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(out), mn, slices);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. part: fp32 workspace of
// ceil(K / kChunkK) * M * N elements. Returns a cudaError_t (0 = launched).
int coalesced_gemm_launch(const void* a, const void* b, const void* gid,
                          void* part, void* out, int M, int K, int N, int bm,
                          int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, gid, part, out, M, K, N, bm, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, b, gid, part, out, M, K, N, bm, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* coalesced_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
