// Flash attention (causal, optional sliding window) for Hopper (sm_90a),
// fp32 and bf16 inputs, on CUDA cores.
//
// Replaces the Pallas TPU kernel `flash_attention` of the JAX package
// (src/repro/kernels/flash_attention.py). Same function: q, k, v [BH, S, D]
// -> out [BH, S, D]; scores q.k * (1/sqrt(D)), masked to cols <= rows
// (causal) and cols > rows - window (window > 0), masked scores filled with
// the finite -2e38; online softmax with fp32 m, l and acc; out =
// acc / max(l, 1e-30), stored in q's dtype. q, k and v are widened to fp32
// and P stays fp32 for P @ V, as in the TPU kernel; only the output is
// rounded. All products are IEEE fp32 FMAs (no tensor cores, no TF32).
//
// The fill stays finite on purpose: a row whose first visited kv tile is
// fully masked then computes p = exp(-2e38 - -2e38) = 1 for a while, and
// the first visible score wipes that out (alpha = exp(-2e38 - m) = 0).
// With -inf the same row would compute exp(-inf - -inf) = NaN.
//
// What bounds it: at the path's shapes (S = 4096, D = 128 or 256) each
// q/k/v byte feeds hundreds of operations, so it is bound by operations.
// On CUDA cores the peak is the fp32 FMA rate; the design keeps the FMA
// units fed from shared memory and never writes the S x S scores out:
//
//   * a block owns one (bh, 64-row q tile) and loops over the kv tiles in
//     32-key steps (the TPU's sequential grid axis becomes this loop); the
//     q tile is staged once in shared memory as fp32, each k/v tile once per
//     step, zero-filled past S;
//   * a warp owns 8 query rows. For Q K^T a lane owns one key of the tile
//     (k rows padded to D + 4 floats, so the lanes' 16-byte reads hit
//     distinct banks; q reads are broadcasts); the row max and row sum are
//     warp shuffles; P goes to shared memory, and for P V a lane owns D/32
//     output columns of each of its warp's 8 rows, in registers;
//   * kv tiles that the causal or window mask hides from every row of the
//     block are skipped (the TPU kernel visits every tile): with a window of
//     1024 over S = 4096 that is 4x less work. The skipped tiles would add
//     exactly nothing (p = 0 after the first visible score), so the result
//     is the one the TPU kernel computes;
//   * q tiles are scheduled heaviest-first (the last causal tiles visit the
//     most kv tiles);
//   * shared memory is dynamic: at D = 256 a block needs 137 KB, above the
//     48 KB static limit, after cudaFuncSetAttribute raises the cap.
//
// Head dims 32, 64, 128 and 256 are compiled; any S >= 1 is taken (the
// ragged edge is masked). Offsets are 64-bit. Bound with ctypes; the launch
// goes on the caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(FA_BLOCK_Q) || !defined(FA_BLOCK_KV) || !defined(FA_WARPS)
#error "the geometry comes from repro_torch/kernels/flash_attention.py (-D)"
#endif

namespace {

constexpr int kBlockQ = FA_BLOCK_Q;
constexpr int kBlockKV = FA_BLOCK_KV;
constexpr int kWarps = FA_WARPS;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = kBlockQ / kWarps;  // query rows of one warp
constexpr float kNeg = -2.0e38f;

static_assert(kBlockKV == 32, "one key of the kv tile per lane");
static_assert(kBlockQ % kWarps == 0, "whole rows per warp");

// Shared memory of one block, in floats: q tile, k tile (rows padded to
// D + 4), v tile, and each warp's P rows.
template <int D>
struct Smem {
  static constexpr int kStrideK = D + 4;
  static constexpr int kQ = kBlockQ * D;
  static constexpr int kK = kBlockKV * kStrideK;
  static constexpr int kV = kBlockKV * D;
  static constexpr int kP = kBlockQ * kBlockKV;
  static constexpr size_t kBytes = sizeof(float) * (kQ + kK + kV + kP);
};

__device__ __forceinline__ void widen16(const float* p, float v[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void widen16(const __nv_bfloat16* p, float v[8]) {
  const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t words[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&words[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Rows [row0, row0 + rows) of one [S, D] matrix into shared memory as fp32,
// row stride `stride` floats; rows at or past S are zero.
template <typename T, int D>
__device__ __forceinline__ void stage(const T* __restrict__ src, int row0,
                                      int rows, int S, float* dst,
                                      int stride) {
  constexpr int kVec = 16 / sizeof(T);
  for (int i = threadIdx.x * kVec; i < rows * D; i += kThreads * kVec) {
    const int r = i / D;
    const int d = i % D;
    float v[kVec];
    if (row0 + r < S) {
      widen16(src + static_cast<int64_t>(row0 + r) * D + d, v);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kVec; e += 4)
      *reinterpret_cast<float4*>(dst + r * stride + d + e) =
          make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
  }
}

// The D / 32 output columns a lane owns: 16-byte groups 128 columns apart
// (D >= 128), a pair (D = 64) or one column (D = 32). Neighbouring lanes
// read neighbouring addresses.
template <int D>
__device__ __forceinline__ int col_of(int lane, int e) {
  if constexpr (D >= 128) return (e / 4) * 128 + lane * 4 + e % 4;
  if constexpr (D == 64) return lane * 2 + e;
  return lane;
}

template <int D>
__device__ __forceinline__ void load_cols(const float* row, int lane,
                                          float v[D / 32]) {
  if constexpr (D >= 128) {
#pragma unroll
    for (int c = 0; c < D / 128; ++c) {
      const float4 t = *reinterpret_cast<const float4*>(row + c * 128 + lane * 4);
      v[4 * c] = t.x;
      v[4 * c + 1] = t.y;
      v[4 * c + 2] = t.z;
      v[4 * c + 3] = t.w;
    }
  } else if constexpr (D == 64) {
    const float2 t = *reinterpret_cast<const float2*>(row + lane * 2);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = row[lane];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S,
                 int causal, int window, float scale) {
  static_assert(D == 32 || D == 64 || D == 128 || D == 256, "head dim");
  constexpr int kDL = D / 32;  // output columns per lane
  using SM = Smem<D>;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* k_s = q_s + SM::kQ;
  float* v_s = k_s + SM::kK;
  float* p_s = v_s + SM::kV;

  const int nq = (S + kBlockQ - 1) / kBlockQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kBlockQ;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * S * D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wrow = warp * kRows;  // the warp's first row within the tile

  stage<T, D>(q + base, q0, kBlockQ, S, q_s, D);

  // the kv tiles some row of this block can see
  const int q_last = min(q0 + kBlockQ, S) - 1;
  const int t_begin = window > 0 ? max(0, q0 - window + 1) / kBlockKV : 0;
  const int t_end = causal ? q_last / kBlockKV + 1
                           : (S + kBlockKV - 1) / kBlockKV;

  float m[kRows], l[kRows], acc[kRows][kDL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNeg;
    l[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < kDL; ++e) acc[r][e] = 0.0f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int c0 = t * kBlockKV;
    __syncthreads();  // the previous tile's readers are done (and q staged)
    stage<T, D>(k + base, c0, kBlockKV, S, k_s, SM::kStrideK);
    stage<T, D>(v + base, c0, kBlockKV, S, v_s, D);
    __syncthreads();

    // scores of the warp's rows against key c0 + lane
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.0f;
    const float* krow = k_s + lane * SM::kStrideK;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(q_s + (wrow + r) * D + d);
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
      }
    }

    const int col = c0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = q0 + wrow + r;
      bool ok = col < S;
      if (causal) ok = ok && col <= row;
      if (window > 0) ok = ok && col > row - window;
      const float sc = ok ? s[r] * scale : kNeg;
      float mx = sc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float p = expf(sc - m_new);
      const float alpha = expf(m[r] - m_new);
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < kDL; ++e) acc[r][e] *= alpha;
      p_s[(wrow + r) * kBlockKV + lane] = p;
    }
    __syncwarp();

    // acc += P V over the tile's 32 keys
#pragma unroll 2
    for (int j = 0; j < kBlockKV; j += 4) {
      float4 pr[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        pr[r] = *reinterpret_cast<const float4*>(p_s + (wrow + r) * kBlockKV + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[kDL];
        load_cols<D>(v_s + (j + jj) * D, lane, vv);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float pj = jj == 0 ? pr[r].x
                           : jj == 1 ? pr[r].y
                           : jj == 2 ? pr[r].z
                                     : pr[r].w;
#pragma unroll
          for (int e = 0; e < kDL; ++e) acc[r][e] = fmaf(pj, vv[e], acc[r][e]);
        }
      }
    }
    __syncwarp();  // p_s is rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + wrow + r;
    if (row >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = out + base + static_cast<int64_t>(row) * D;
#pragma unroll
    for (int e = 0; e < kDL; ++e) store(orow + col_of<D>(lane, e), acc[r][e] / denom);
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int BH,
             int S, int causal, int window, float scale, cudaStream_t stream) {
  const auto kernel = flash_kernel<T, D>;
  const int smem = static_cast<int>(Smem<D>::kBytes);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, BH);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, causal, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int S, int D, int causal, int window, float scale,
           cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_d<T, 32>(q, k, v, out, BH, S, causal, window, scale, stream);
    case 64:
      return launch_d<T, 64>(q, k, v, out, BH, S, causal, window, scale, stream);
    case 128:
      return launch_d<T, 128>(q, k, v, out, BH, S, causal, window, scale, stream);
    case 256:
      return launch_d<T, 256>(q, k, v, out, BH, S, causal, window, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int BH, int S, int D, int causal,
                           int window, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, BH, S, D, causal, window, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, BH, S, D, causal, window,
                                 scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of one block at head dim D, in bytes (0 if D is not
// compiled): the wrapper's launch guard holds its own count against it.
int flash_attention_smem_bytes(int D) {
  switch (D) {
    case 32: return static_cast<int>(Smem<32>::kBytes);
    case 64: return static_cast<int>(Smem<64>::kBytes);
    case 128: return static_cast<int>(Smem<128>::kBytes);
    case 256: return static_cast<int>(Smem<256>::kBytes);
    default: return 0;
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
