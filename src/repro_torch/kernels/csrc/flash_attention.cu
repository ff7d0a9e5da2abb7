// Flash attention (causal, optional sliding window) for Hopper (sm_90a), on
// tensor cores through mma.sync: bf16 inputs as bf16 MMAs with P split into
// two bf16 halves, fp32 inputs as 3xTF32.
//
// Replaces the Pallas TPU kernel `flash_attention` of the JAX package
// (src/repro/kernels/flash_attention.py). Same function: q, k, v [BH, S, D]
// -> out [BH, S, D]; scores q.k * (1/sqrt(D)), masked to cols <= rows
// (causal) and cols > rows - window (window > 0), masked scores filled with
// the finite -2e38; online softmax with fp32 m, l and acc; out =
// acc / max(l, 1e-30), stored in q's dtype.
//
// The fill stays finite on purpose: a row whose first visited kv tile is
// fully masked then computes p = exp(-2e38 - -2e38) = 1 for a while, and
// the first visible score wipes that out (alpha = exp(-2e38 - m) = 0).
// With -inf the same row would compute exp(-inf - -inf) = NaN. The kernel
// works in the log2 domain (exp2f, the scale folded into log2(e)), where the
// fill becomes -2e38 * log2(e) = -2.885e38: still finite in fp32.
//
// The numbers. The TPU kernel widens q, k, v to fp32 and keeps P in fp32
// for P V; the card's checks hold this kernel to the plain fp32 version at
// rtol 1e-2 / atol 1e-4 in bf16 (one bf16 ulp) and 2e-5 / 2e-4 in fp32.
// tests/test_torch_attention.py emulates each choice below in plain torch
// (causal, normal inputs from seed 0):
//
//   * bf16, Q K^T: bf16 x bf16 products are exact in fp32 and the MMA sums
//     in fp32, so nothing is lost.
//   * bf16, P V: P rounded once to bf16 puts 23,417 of 524,288 outputs
//     outside the limit at [8, 512, 128] and 34,650 of 1,048,576 at
//     [4, 1024, 256] (largest error 1.6e-2). So P is split in registers,
//     P_hi = bf16(P), P_lo = bf16(P - P_hi), and both halves go through
//     the MMA against the same V fragments: 0 outside at both shapes.
//   * fp32: plain TF32 (operands rounded to 10-bit mantissas) puts 3,057 of
//     262,144 outputs outside the fp32 limit at [4, 512, 128] (largest
//     error 1.3e-3). 3xTF32 splits every operand by rounding to nearest,
//     ties away (cvt.rna.tf32.f32's rounding, done as an integer add and
//     mask): hi = rna(x), lo = rna(x - hi) (never the MMA's own
//     truncation), and sums a_hi b_hi + a_hi b_lo + a_lo b_hi, for Q K^T
//     and for P V: 0 outside, largest error 1.2e-6.
//
// What bounds it. At the path's shapes (S = 4096, D = 128 or 256) each
// q/k/v byte feeds hundreds of operations, so the work is bound by
// operations: the bf16 tensor-core rate (989 TFLOP/s) in bf16, where the
// split P V doubles the MMAs of that half (about 1.5x the nominal work);
// in fp32 the TF32 rate (495 TFLOP/s) over three MMAs a product, 6x the
// nominal fp32 work at half the bf16 rate. Besides the MMAs, every warp
// reads its K and V fragments from shared memory with ldmatrix (the block's
// four warps read the same tile), which costs about as many cycles as the
// MMAs at D = 128.
//
// The design:
//
//   * a block owns one (bh, 64-row q tile); a warp owns 16 query rows (one
//     m16 MMA tile) and keeps its S tile, m, l and the D-wide accumulator
//     in registers, in the MMA's accumulator layout; the TPU's sequential
//     kv grid axis becomes a loop over kv tiles;
//   * q, k and v are staged in shared memory in their own dtype (never
//     widened), rows padded by 16 bytes so that the 8 rows an ldmatrix
//     phase reads start in 8 different 16-byte bank groups;
//   * k/v tiles arrive through cp.async 16-byte copies into a ring of
//     FA_STAGES (k, v) tiles, the next tile's copy in flight while the
//     current one is computed; rows past S are zero-filled;
//   * Q K^T: Q and K fragments by ldmatrix (the same byte addressing serves
//     bf16 m16n8k16 and tf32 m16n8k8: a k-step is 32 bytes of a row);
//   * mask and online softmax on the accumulator fragments: a row lives on
//     the 4 lanes of a quad, so its max is two quad shuffles; l is kept per
//     lane (from the fp32 P) and summed over the quad once, at the end.
//     Tiles that no mask touches skip the per-element mask;
//   * P never goes to shared memory. In bf16 the m16n8 accumulator layout
//     of two neighbouring S tiles is the m16n8k16 A layout, so P_hi and
//     P_lo are packed in place and V comes by ldmatrix.trans. In tf32 the
//     accumulator holds keys 2t, 2t+1 where the m16n8k8 A operand wants
//     keys t, t+4: the kernel permutes the key order inside each 8-key
//     step instead (A column t is key 2t, column t + 4 is key 2t + 1) and
//     reads V's rows in the same order, with scalar loads that the
//     (D + 4)-float row stride keeps free of bank conflicts;
//   * kv tiles that the causal or window mask hides from every row of the
//     block are skipped (the TPU kernel visits every tile): with a window of
//     1024 over S = 4096 that is 4x less work. The skipped tiles would add
//     exactly nothing (p = 0 after the first visible score), so the result
//     is the one the TPU kernel computes;
//   * q tiles are scheduled heaviest-first (the last causal tiles visit the
//     most kv tiles); no atomics, so the result is the same from run to run;
//   * kv tiles of 32 keys, in both dtypes and at every D: at D = 256 the
//     accumulator alone is 128 registers a thread, and at D = 128 the
//     smaller tiles let more blocks share an SM (more warps to hide the
//     MMA and ldmatrix latency), which measured faster than 64 keys.
//     Shared memory is dynamic, up to 195 KB (fp32, D = 256), after
//     cudaFuncSetAttribute raises the cap.
//
// The next step is Hopper's own machinery, not used here: wgmma (a
// warpgroup's 64-row MMA with B read from shared memory, so the four warps
// stop re-reading K and V through ldmatrix), TMA copies with mbarriers in
// place of cp.async, and warp specialisation (a producer warp feeding
// consumer warpgroups).
//
// Head dims 32, 64, 128 and 256 are compiled for both dtypes; any S >= 1 is
// taken (the ragged edge is masked). Offsets are 64-bit. Bound with ctypes;
// the launch goes on the caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#if !defined(FA_BLOCK_Q) || !defined(FA_BLOCK_KV) || !defined(FA_STAGES)
#error "the geometry comes from repro_torch/kernels/flash_attention.py (-D)"
#endif

namespace {

constexpr int kBlockQ = FA_BLOCK_Q;
constexpr int kBlockKV = FA_BLOCK_KV;
constexpr int kWarps = kBlockQ / 16;  // one 16-row MMA tile per warp
constexpr int kStages = FA_STAGES;
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNeg = -2.0e38f * kLog2e;  // the fill, in the log2 domain

static_assert(kBlockQ % 16 == 0, "whole 16-row MMA tiles");
static_assert(kBlockKV % 16 == 0, "kv tiles of whole 16-key MMA steps");
static_assert(kStages >= 1, "at least one k/v stage");

// One instance's geometry. Shared memory: the q tile, then kStages (k, v)
// tile pairs; every row holds D elements and 16 bytes of padding.
template <typename T, int D>
struct Geom {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(T)) + 16;
  static constexpr int kQBytes = kBlockQ * kRowBytes;
  static constexpr int kTileBytes = kBlockKV * kRowBytes;
  static constexpr int kBytes = kQBytes + 2 * kStages * kTileBytes;
  static constexpr int kKSteps = D * static_cast<int>(sizeof(T)) / 32;
  static constexpr int kNT = kBlockKV / 8;  // 8-key column tiles of S
  static constexpr int kDT = D / 8;         // 8-column tiles of the output
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; `bytes` = 0 zero-fills them
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b on bf16 tensor cores (fp32 accumulation), m16n8k16
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b on TF32 tensor cores (fp32 accumulation), m16n8k8
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// finite x rounded to TF32 (10-bit mantissa) to nearest, ties away from
// zero, in fp32 layout: the rounding of cvt.rna.tf32.f32, done as two
// integer operations (add half of the dropped 13 bits' weight, clear them)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32 (x - hi is exact in fp32)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c += a b as 3xTF32: a_lo b_hi + a_hi b_lo + a_hi b_hi (a_lo b_lo dropped)
__device__ __forceinline__ void mma_3xtf32(float c[4], const uint32_t ah[4],
                                           const uint32_t al[4], uint32_t bh0,
                                           uint32_t bh1, uint32_t bl0,
                                           uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// (x0, x1) = hi + lo, each a packed bf16 pair (x0 in the low half)
__device__ __forceinline__ void split_bf16x2(float x0, float x1,
                                             uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ void store2(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

// Rows [row0, row0 + rows) of one [S, D] matrix into padded shared-memory
// rows at `dst`, by cp.async; rows at or past S are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_rows(const T* __restrict__ src,
                                          int row0, int rows, int S,
                                          uint32_t dst) {
  constexpr int kChunks = D * static_cast<int>(sizeof(T)) / 16;
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const bool in = row0 + r < S;
    const char* g = reinterpret_cast<const char*>(
                        src + static_cast<int64_t>(in ? row0 + r : 0) * D) +
                    c * 16;
    cp_async16(dst + r * Geom<T, D>::kRowBytes + c * 16, g, in ? 16 : 0);
  }
}

// S = Q K^T for the warp's 16 rows and the tile's keys, in the accumulator
// layout: s[n][0..1] = row g, keys 8n + 2t + {0, 1}; s[n][2..3] = row g + 8.
// `q_lane` / `k_lane`: this lane's ldmatrix row address in the q / k tile.
template <typename T, int D>
__device__ __forceinline__ void scores(float s[][4], uint32_t q_lane,
                                       uint32_t k_lane) {
  using G = Geom<T, D>;
#pragma unroll
  for (int n = 0; n < G::kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < G::kKSteps; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, q_lane + kk * 32);
    if constexpr (G::kBf16) {
#pragma unroll
      for (int n = 0; n < G::kNT; n += 2) {
        uint32_t b[4];
        ldsm_x4(b, k_lane + n * 8 * G::kRowBytes + kk * 32);
        mma_bf16(s[n], a, b[0], b[1]);
        mma_bf16(s[n + 1], a, b[2], b[3]);
      }
    } else {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split_tf32(__uint_as_float(a[i]), ah[i], al[i]);
#pragma unroll
      for (int n = 0; n < G::kNT; n += 2) {
        uint32_t b[4], bh[4], bl[4];
        ldsm_x4(b, k_lane + n * 8 * G::kRowBytes + kk * 32);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split_tf32(__uint_as_float(b[i]), bh[i], bl[i]);
        mma_3xtf32(s[n], ah, al, bh[0], bh[1], bl[0], bl[1]);
        mma_3xtf32(s[n + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
      }
    }
  }
}

// acc += P V over the tile's keys; p in the layout of `scores`.
// bf16: `v_lane` is this lane's ldmatrix.trans address in the v tile.
// fp32: `v_rows` points at the v tile.
template <typename T, int D>
__device__ __forceinline__ void accumulate_pv(float acc[][4], float p[][4],
                                              uint32_t v_lane,
                                              const float* v_rows, int lane) {
  using G = Geom<T, D>;
  if constexpr (G::kBf16) {
#pragma unroll
    for (int kk = 0; kk < kBlockKV / 16; ++kk) {
      // S tiles 2kk and 2kk + 1 are the A operand of one 16-key step
      uint32_t ph[4], pl[4];
      split_bf16x2(p[2 * kk][0], p[2 * kk][1], ph[0], pl[0]);
      split_bf16x2(p[2 * kk][2], p[2 * kk][3], ph[1], pl[1]);
      split_bf16x2(p[2 * kk + 1][0], p[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16x2(p[2 * kk + 1][2], p[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dn = 0; dn < G::kDT; dn += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, v_lane + kk * 16 * G::kRowBytes + dn * 16);
        mma_bf16(acc[dn], ph, b[0], b[1]);
        mma_bf16(acc[dn], pl, b[0], b[1]);
        mma_bf16(acc[dn + 1], ph, b[2], b[3]);
        mma_bf16(acc[dn + 1], pl, b[2], b[3]);
      }
    }
  } else {
    constexpr int kStride = G::kRowBytes / 4;  // D + 4 floats
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < G::kNT; ++j) {
      // A column t is key 8j + 2t, column t + 4 is key 8j + 2t + 1
      uint32_t ah[4], al[4];
      split_tf32(p[j][0], ah[0], al[0]);
      split_tf32(p[j][2], ah[1], al[1]);
      split_tf32(p[j][1], ah[2], al[2]);
      split_tf32(p[j][3], ah[3], al[3]);
      const float* vr = v_rows + (8 * j + 2 * t) * kStride + g;
#pragma unroll
      for (int dn = 0; dn < G::kDT; ++dn) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(vr[dn * 8], bh0, bl0);
        split_tf32(vr[kStride + dn * 8], bh1, bl1);
        mma_3xtf32(acc[dn], ah, al, bh0, bh1, bl0, bl1);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S,
                 int causal, int window, float scale_log2) {
  static_assert(D == 32 || D == 64 || D == 128 || D == 256, "head dim");
  using G = Geom<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_q = smem_u32(smem);
  const uint32_t s_kv = s_q + G::kQBytes;  // stage i: k, then v

  const int nq = (S + kBlockQ - 1) / kBlockQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kBlockQ;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * S * D;
  const T* kb = k + base;
  const T* vb = v + base;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row_a = q0 + warp * 16 + (lane >> 2);  // and row_a + 8

  // the kv tiles some row of this block can see
  const int q_last = min(q0 + kBlockQ, S) - 1;
  const int t_begin = window > 0 ? max(0, q0 - window + 1) / kBlockKV : 0;
  const int t_end =
      causal ? q_last / kBlockKV + 1 : (S + kBlockKV - 1) / kBlockKV;
  const int n_tiles = t_end - t_begin;

  load_rows<T, D>(q + base, q0, kBlockQ, S, s_q);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) {
      const int c0 = (t_begin + i) * kBlockKV;
      const uint32_t s_k = s_kv + 2 * i * G::kTileBytes;
      load_rows<T, D>(kb, c0, kBlockKV, S, s_k);
      load_rows<T, D>(vb, c0, kBlockKV, S, s_k + G::kTileBytes);
    }
    cp_async_commit();
  }

  // this lane's ldmatrix row addresses: Q as the A operand (rows
  // 16 warp + (lane & 15), second 16 bytes of the step for lanes >= 16);
  // K as B, two 8-key tiles at once; V as B through .trans, two 8-column
  // tiles at once
  const uint32_t q_lane =
      s_q + (warp * 16 + (lane & 15)) * G::kRowBytes + (lane >> 4) * 16;
  const uint32_t k_off =
      ((lane & 7) + (lane >> 4) * 8) * G::kRowBytes + ((lane >> 3) & 1) * 16;
  const uint32_t v_off =
      ((lane & 7) + ((lane >> 3) & 1) * 8) * G::kRowBytes + (lane >> 4) * 16;

  float m[2] = {kNeg, kNeg};
  float l[2] = {0.0f, 0.0f};  // this lane's share of the row sums
  float acc[G::kDT][4];
#pragma unroll
  for (int dn = 0; dn < G::kDT; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.0f;

  for (int i = 0; i < n_tiles; ++i) {
    {  // the tile kStages - 1 ahead goes into the stage freed last step
      const int j = i + kStages - 1;
      if (j < n_tiles) {
        const int c0 = (t_begin + j) * kBlockKV;
        const uint32_t s_k = s_kv + 2 * (j % kStages) * G::kTileBytes;
        load_rows<T, D>(kb, c0, kBlockKV, S, s_k);
        load_rows<T, D>(vb, c0, kBlockKV, S, s_k + G::kTileBytes);
      }
      cp_async_commit();
    }
    cp_async_wait<kStages - 1>();
    __syncthreads();  // tile i (and the q tile) is in shared memory

    const int st = i % kStages;
    const uint32_t s_k = s_kv + 2 * st * G::kTileBytes;
    float s[G::kNT][4];
    scores<T, D>(s, q_lane, s_k + k_off);

    // scale (log2 domain) and mask; tiles no mask touches skip the mask
    const int c0 = (t_begin + i) * kBlockKV;
    const bool edge = (causal && c0 + kBlockKV - 1 > q0) ||
                      (window > 0 && c0 <= q0 + kBlockQ - 1 - window) ||
                      c0 + kBlockKV > S;
#pragma unroll
    for (int n = 0; n < G::kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int col = c0 + 8 * n + 2 * (lane & 3) + (e & 1);
          const int row = row_a + 8 * (e >> 1);
          bool ok = col < S;
          if (causal) ok = ok && col <= row;
          if (window > 0) ok = ok && col > row - window;
          x = ok ? x : kNeg;
        }
        s[n][e] = x;
      }

    // online softmax: the new row max over the quad, then P in place
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < G::kNT; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
    }
#pragma unroll
    for (int n = 0; n < G::kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
#pragma unroll
    for (int dn = 0; dn < G::kDT; ++dn) {
      acc[dn][0] *= alpha[0];
      acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1];
      acc[dn][3] *= alpha[1];
    }

    const uint32_t s_v = s_k + G::kTileBytes;
    accumulate_pv<T, D>(
        acc, s, s_v + v_off,
        reinterpret_cast<const float*>(smem + (s_v - s_q)), lane);
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_a + 8 * h;
    if (row >= S) continue;
    const float denom = fmaxf(l[h], 1e-30f);
    T* orow = out + base + static_cast<int64_t>(row) * D + 2 * (lane & 3);
#pragma unroll
    for (int dn = 0; dn < G::kDT; ++dn)
      store2(orow + dn * 8, acc[dn][2 * h] / denom,
             acc[dn][2 * h + 1] / denom);
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int BH,
             int S, int causal, int window, float scale, cudaStream_t stream) {
  const auto kernel = flash_kernel<T, D>;
  const int smem = Geom<T, D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, BH);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, causal, window,
      scale * kLog2e);
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

template <typename T>
int smem_bytes(int D) {
  switch (D) {
    case 32: return Geom<T, 32>::kBytes;
    case 64: return Geom<T, 64>::kBytes;
    case 128: return Geom<T, 128>::kBytes;
    case 256: return Geom<T, 256>::kBytes;
    default: return 0;
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

// Dynamic shared memory of one block at head dim D and dtype (as above), in
// bytes (0 if the instance is not compiled): the wrapper's launch guard
// holds its own count against it.
int flash_attention_smem_bytes(int D, int dtype) {
  if (dtype == 0) return smem_bytes<float>(D);
  if (dtype == 1) return smem_bytes<__nv_bfloat16>(D);
  return 0;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
