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
// operations-per-byte ridge. The design spreads the w stream over every SM
// and keeps many 16-byte loads in flight:
//
//   * a block owns one problem g and one tile of kRowLanes * 16 bytes of
//     output columns: grid = (N / tile, G);
//   * the block's threads form row groups of kRowLanes lanes; each lane of
//     a group loads 16 neighbouring bytes of one k row (a group reads the
//     tile's kRowLanes * 16 contiguous bytes of the row), and the row
//     groups split K between them, so every w element is read exactly
//     once; each thread keeps kUnroll loads in flight;
//   * x[g] is staged in shared memory as fp32, kChunkK elements at a time;
//   * the row groups' partial sums are added in a fixed order in shared
//     memory. No atomics: the output is deterministic.
//
// w is indexed with 64-bit offsets. Any K >= 1 is taken; N must be a
// multiple of the column tile (the wrapper's launch guard checks it).
//
// Bound with ctypes (plain C entry points below); the launch goes on the
// caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(GV_THREADS) || !defined(GV_ROW_LANES) || !defined(GV_CHUNK_K) || \
    !defined(GV_UNROLL)
#error "the geometry comes from repro_torch/kernels/coalesced_gemv.py (-D)"
#endif

namespace {

constexpr int kThreads = GV_THREADS;
constexpr int kRowLanes = GV_ROW_LANES;     // lanes that share one k row
constexpr int kChunkK = GV_CHUNK_K;         // x elements staged at a time
constexpr int kUnroll = GV_UNROLL;          // loads in flight per thread
constexpr int kRowGroups = kThreads / kRowLanes;
constexpr int kMaxTileN = kRowLanes * 8;    // bf16: 8 elements per 16 bytes

static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps");
static_assert(32 % kRowLanes == 0, "a row group lies inside one warp");
static_assert(sizeof(float) * (kChunkK + kRowGroups * kMaxTileN) <= 48 * 1024,
              "static shared memory of one block");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes of w: 4 fp32 or 8 bf16 values, widened to fp32.
__device__ __forceinline__ void load16(const float* p, float v[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

// bf16 -> fp32 is exact: the bf16 bits are the high half of the fp32 word
// (shifts on the loaded words keep them in registers)
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float v[8]) {
  const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t words[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(words[i] << 16);
    v[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
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
  __shared__ float x_s[kChunkK];
  __shared__ float red[kRowGroups][kTileN];

  const int64_t g = blockIdx.y;
  const int n0 = blockIdx.x * kTileN;
  const int tid = threadIdx.x;
  const int group = tid / kRowLanes;
  const int lane = tid % kRowLanes;
  const T* xg = x + g * K;
  const T* wg = w + g * static_cast<int64_t>(K) * N + n0 + lane * kVec;

  float acc[kVec];
#pragma unroll
  for (int c = 0; c < kVec; ++c) acc[c] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kChunkK) {
    const int kn = min(kChunkK, K - k0);
    __syncthreads();  // the previous chunk's readers are done with x_s
    for (int i = tid; i < kn; i += kThreads) x_s[i] = to_float(xg[k0 + i]);
    __syncthreads();
    const T* wr = wg + static_cast<int64_t>(k0) * N;
#pragma unroll kUnroll
    for (int kk = group; kk < kn; kk += kRowGroups) {
      float wv[kVec];
      load16(wr + static_cast<int64_t>(kk) * N, wv);
      const float xv = x_s[kk];
#pragma unroll
      for (int c = 0; c < kVec; ++c) acc[c] = fmaf(xv, wv[c], acc[c]);
    }
  }

#pragma unroll
  for (int c = 0; c < kVec; ++c) red[group][lane * kVec + c] = acc[c];
  __syncthreads();
  for (int c = tid; c < kTileN; c += kThreads) {
    float sum = 0.0f;
#pragma unroll 8
    for (int r = 0; r < kRowGroups; ++r) sum += red[r][c];
    store(out + g * N + n0 + c, sum);
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, int G, int K, int N,
           cudaStream_t stream) {
  constexpr int kTileN = kRowLanes * (16 / static_cast<int>(sizeof(T)));
  const dim3 grid(N / kTileN, G);
  gemv_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
int coalesced_gemv_launch(const void* x, const void* w, void* out, int G,
                          int K, int N, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, out, G, K, N, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, out, G, K, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* coalesced_gemv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
