// Grouped GEMM superkernel for Hopper (sm_90a), fp32 and bf16, on the tensor
// cores through mma.sync: bf16 as bf16 MMAs, fp32 as 3xTF32.
//
// Replaces the Pallas TPU kernel `coalesced_gemm` of the JAX package
// (src/repro/kernels/coalesced_gemm.py). Same function: A [M, K] holds G
// problems concatenated along m, each padded to a multiple of `bm` rows;
// B [G, K, N] holds the per-problem weight envelopes; gid [M / bm] (int32,
// on the device) names the problem of each bm-row m-tile. Row r of the
// result is A[r, :] @ B[gid[r / bm]], accumulated in fp32 and stored in A's
// dtype. Pad rows of A are zero, so they come back zero.
//
// What bounds it: on the serving path m is a decode batch (a few rows per
// problem), so every weight byte read feeds 2 * rows operations, far below
// the card's operations-per-byte ridge. The kernel is bound by the bytes of
// B it streams, and the design streams each byte of B once per launch:
//
//   * a block owns one group g (blockIdx.z), 128 output columns (blockIdx.y)
//     and one range of K (its rank in a thread block cluster, blockIdx.x).
//     It finds the group's rows itself, by scanning gid for the 8-row
//     chunks of group g, and applies every B tile it loads to all of them:
//     pad tiles of the group cost MMA columns on zero rows, not bytes, and a
//     group without rows streams nothing. Up to 64 rows (8 chunks) make one
//     pass; a group with more rows (not on the serving path) streams its B
//     range again for each further 64 rows;
//   * B and the pass's rows of A arrive through cp.async 16-byte copies into
//     a ring of CG_STAGES tiles in dynamic shared memory; tile t + 1 is in
//     flight while tile t is computed. A k tile is CG_TILE_BYTES of k a row
//     (64 deep in bf16, 32 in fp32), 16 KB of B. Two stages keep 52 KB a
//     block, so four blocks share an SM with 64 KB of B in flight: on the
//     H100 that streamed B faster than two blocks of four stages or one of
//     six (more bytes in flight, fewer blocks). The K tail is zero-filled (a
//     copy of source size 0), never read past the end. Rows of A whose pitch
//     is not a multiple of 16 bytes (K * dtype size) are copied element by
//     element instead;
//   * the MMAs run with A and B swapped: the weights fill the MMA's 16-row M
//     dimension and the group's rows its 8-wide N dimension. A warp owns 32
//     columns (two m16 tiles) and every chunk: 64 fp32 accumulators a
//     thread, in the m16n8 accumulator layout;
//   * bf16: mma.sync.m16n8k16 (bf16 in, fp32 accumulate) takes B^T
//     (16 columns x 16 k) as its A operand, loaded with ldmatrix.trans from
//     the [k][n] tile, and one 8-row chunk of A as its B operand, loaded
//     with ldmatrix from the [row][k] tile. bf16 x bf16 products are exact in
//     fp32. B's rows are padded 16 bytes, so the 8 rows an ldmatrix phase
//     reads fall in distinct banks;
//   * fp32: 3xTF32 on mma.sync.m16n8k8 (as in flash_attention.cu): every
//     operand is split into hi = rna(x) and lo = rna(x - hi), both TF32, and
//     each product is a_lo b_hi + a_hi b_lo + a_hi b_hi, about 21 bits. Plain
//     TF32 would break the fp32 tolerance. Fragments are scalar loads; B's
//     rows are padded 32 bytes, so a warp's loads hit distinct banks. On CUDA
//     cores the fp32 FMAs and their shared-memory reads took longer than the
//     B stream at the path's shapes;
//   * split-K without a workspace: the K ranges of one (g, column tile) are
//     the blocks of one cluster (at most 8, the portable limit). Each block
//     leaves its fp32 partial tile in its own shared memory; after
//     cluster.sync() rank q adds rows q, q + S, ... of the S partials
//     through distributed shared memory, in rank order 0 .. S - 1, and
//     stores them in A's dtype. One launch, no workspace, no second kernel.
//
// The cluster size S comes from the wrapper (kernels/coalesced_gemm.py,
// `k_split`) and is a function of K and this geometry only, never of M, N
// or G: a row's summation order (its MMAs in k order within a rank, then the
// ranks in order) does not depend on what else was coalesced into the
// launch, so the time, batched and vliw modes give the same tokens. No
// atomics: the same inputs give bitwise the same output on every call.
//
// B is indexed with 64-bit offsets: a packed vocabulary projection
// [G, 4096, 65536] passes 2^31 elements at G = 8. Bound with ctypes (plain C
// entry points below); the launch goes on the caller's stream and returns
// cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(CG_ROWS) || !defined(CG_BLOCK_N) || !defined(CG_THREADS) || \
    !defined(CG_STAGES) || !defined(CG_TILE_BYTES) ||                    \
    !defined(CG_PASS_CHUNKS) || !defined(CG_MAX_CLUSTER)
#error "the geometry comes from repro_torch/kernels/coalesced_gemm.py (-D)"
#endif

namespace {

namespace coop = cooperative_groups;

// The geometry is the wrapper's (kernels/coalesced_gemm.py): it passes it
// here as -D defines and sizes its launch guard from the same values. What
// this code needs of it is checked below, when it is built.
constexpr int kRows = CG_ROWS;                // rows of a chunk (bm % 8 == 0)
constexpr int kBlockN = CG_BLOCK_N;           // output columns per block
constexpr int kThreads = CG_THREADS;
constexpr int kStages = CG_STAGES;            // tiles in the cp.async ring
constexpr int kTileBytes = CG_TILE_BYTES;     // bytes of k per row per tile
constexpr int kPassChunks = CG_PASS_CHUNKS;   // chunks of one pass
constexpr int kMaxCluster = CG_MAX_CLUSTER;
constexpr int kWarps = kThreads / 32;
constexpr int kPassRows = kPassChunks * kRows;
constexpr int kPartPitch = kBlockN + 4;       // floats a row of a partial
constexpr int kAcc = 2 * kPassChunks * 4;     // accumulators a thread
constexpr int kMaxSmem = 232448;              // 227 KB a block

static_assert(kRows == 8, "a chunk is one n8 MMA tile");
static_assert(kWarps * 32 == kBlockN && kThreads == kBlockN,
              "a warp owns 32 columns: two m16 MMA tiles");
static_assert(kPassChunks % 2 == 0, "ldmatrix.x4 reads chunks in pairs");
static_assert(kAcc <= 64, "accumulator registers");
static_assert(kStages >= 2, "a ring of at least two tiles");
static_assert(kMaxCluster >= 1 && kMaxCluster <= 8,
              "at most 8 blocks a cluster (the portable limit)");

// One instance's shared memory. The ring: kStages stages, each a B tile
// [k][kBlockN] and the pass's A rows [row][k], rows padded. After the last
// tile the ring's start holds the block's fp32 partial tile
// [kPassRows][kPartPitch] for the cluster's reduction.
template <typename T>
struct Geom {
  static constexpr int kElem = static_cast<int>(sizeof(T));
  static constexpr int kTileK = kTileBytes / kElem;        // k per tile
  static constexpr int kKStep = kElem == 2 ? 16 : 8;       // k per MMA
  static constexpr int kBPitch = kBlockN * kElem + (kElem == 2 ? 16 : 32);
  static constexpr int kAPitch = kTileBytes + 16;          // bytes
  static constexpr int kBBytes = kTileK * kBPitch;
  static constexpr int kStageBytes = kBBytes + kPassRows * kAPitch;
  static constexpr int kBytes = kStages * kStageBytes;
  static constexpr int kBRowCopies = kBlockN * kElem / 16;  // 16-byte copies
  static constexpr int kBCopies = kTileK * kBRowCopies / kThreads;
  static constexpr int kARowCopies = kTileBytes / 16;
  static_assert(kTileK * kBRowCopies % kThreads == 0,
                "a B tile is whole rounds of 16-byte copies");
  static_assert(kTileK % kKStep == 0, "whole MMA k steps a tile");
  static_assert(kBPitch % 16 == 0 && kAPitch % 16 == 0 &&
                    kStageBytes % 16 == 0,
                "16-byte aligned copies and ldmatrix rows");
  static_assert(kPassRows * kPartPitch * 4 <= kBytes,
                "the partial tile fits in the ring");
  static_assert(kBytes + 64 <= kMaxSmem, "shared memory of one block");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; the bytes past `bytes` (0 .. 16)
// are zero-filled
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
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b on TF32 tensor cores (fp32 accumulation), m16n8k8
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t a[4],
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

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void zero(float* p) { *p = 0.0f; }
__device__ __forceinline__ void zero(__nv_bfloat16* p) {
  *p = __float2bfloat16_rn(0.0f);
}

// B rows k0 .. k0 + kTileK of group g's 128-column panel `bg` into `dst`;
// rows past K are zero-filled
template <typename T>
__device__ __forceinline__ void load_b(uint32_t dst, const T* bg, int k0,
                                       int K, int N) {
  using G = Geom<T>;
#pragma unroll
  for (int i = 0; i < G::kBCopies; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / G::kBRowCopies;
    const int q = c % G::kBRowCopies;
    const int k = k0 + r;
    const T* src =
        k < K ? bg + static_cast<int64_t>(k) * N + q * (16 / G::kElem) : bg;
    cp_async16(dst + r * G::kBPitch + q * 16, src, k < K ? 16 : 0);
  }
}

// The pass's rows of A (chunks `chunk[0 .. nrows / 8)`), k0 .. k0 + kTileK,
// into `dst`; k past K is zero-filled. `vec`: rows start 16-byte aligned.
template <typename T>
__device__ __forceinline__ void load_a(unsigned char* dst, const T* a,
                                       const int* chunk, int nrows, int k0,
                                       int K, bool vec) {
  using G = Geom<T>;
  constexpr int kPer = 16 / G::kElem;   // elements a copy
  for (int c = threadIdx.x; c < nrows * G::kARowCopies; c += kThreads) {
    const int r = c / G::kARowCopies;
    const int q = c % G::kARowCopies;
    const int k = k0 + q * kPer;
    const T* row = a + static_cast<int64_t>(chunk[r / kRows] * kRows +
                                            r % kRows) * K;
    unsigned char* d = dst + r * G::kAPitch + q * 16;
    if (vec) {
      const int bytes = k >= K ? 0 : min(kPer, K - k) * G::kElem;
      cp_async16(smem_u32(d), bytes ? row + k : a, bytes);
    } else {
      T* e = reinterpret_cast<T*>(d);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (k + j < K)
          e[j] = row[k + j];
        else
          zero(e + j);
      }
    }
  }
}

// One k tile of the pass, bf16: warp w, columns 32 w .. 32 w + 31 as two
// m16 tiles, every chunk as an n8 tile.
__device__ __forceinline__ void compute_tile(float acc[kAcc],
                                             const unsigned char* stage,
                                             int nc, __nv_bfloat16*) {
  using G = Geom<__nv_bfloat16>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t sb = smem_u32(stage);
  const uint32_t sa = sb + G::kBBytes;
  // ldmatrix.x4: lanes 8q .. 8q + 7 give the 8 row addresses of matrix q
  const int q_hi = lane >> 4;          // matrices 2, 3
  const int q_lo = (lane >> 3) & 1;    // matrices 1, 3
  const int r8 = lane & 7;
#pragma unroll
  for (int s = 0; s < G::kTileK / 16; ++s) {
    // B^T as the A operand: a0..a3 = (n 0-7, k 0-7), (n 8-15, k 0-7),
    // (n 0-7, k 8-15), (n 8-15, k 8-15); stored [k][n], so .trans
    uint32_t w[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldsm_x4_trans(w[mt], sb + (16 * s + 8 * q_hi + r8) * G::kBPitch +
                               (32 * warp + 16 * mt + 8 * q_lo) * 2);
#pragma unroll
    for (int jp = 0; jp < kPassChunks / 2; ++jp) {
      if (2 * jp < nc) {
        // two chunks as B operands: (chunk 2jp: k 0-7, k 8-15), (chunk
        // 2jp + 1: k 0-7, k 8-15); stored [row][k]
        uint32_t x[4];
        ldsm_x4(x, sa + ((2 * jp + q_hi) * kRows + r8) * G::kAPitch +
                       (16 * s + 8 * q_lo) * 2);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma_bf16(acc + (mt * kPassChunks + 2 * jp) * 4, w[mt], x[0], x[1]);
        if (2 * jp + 1 < nc) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            mma_bf16(acc + (mt * kPassChunks + 2 * jp + 1) * 4, w[mt], x[2],
                     x[3]);
        }
      }
    }
  }
}

// One k tile of the pass, fp32 as 3xTF32: the same warp and fragment
// layout on m16n8k8, operands split into TF32 hi and lo parts.
__device__ __forceinline__ void compute_tile(float acc[kAcc],
                                             const unsigned char* stage,
                                             int nc, float*) {
  using G = Geom<float>;
  constexpr int kWP = G::kBPitch / 4;   // floats a row of B
  constexpr int kXP = G::kAPitch / 4;   // floats a row of A
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float* ws = reinterpret_cast<const float*>(stage);
  const float* xs = reinterpret_cast<const float*>(stage + G::kBBytes);
#pragma unroll
  for (int s = 0; s < G::kTileK / 8; ++s) {
    // B^T as the A operand: a0..a3 = (n g, k t), (n g + 8, k t),
    // (n g, k t + 4), (n g + 8, k t + 4)
    uint32_t wh[2][4], wl[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float* w = ws + (8 * s + t) * kWP + 32 * warp + 16 * mt + g;
      split_tf32(w[0], wh[mt][0], wl[mt][0]);
      split_tf32(w[8], wh[mt][1], wl[mt][1]);
      split_tf32(w[4 * kWP], wh[mt][2], wl[mt][2]);
      split_tf32(w[4 * kWP + 8], wh[mt][3], wl[mt][3]);
    }
#pragma unroll
    for (int j = 0; j < kPassChunks; ++j) {
      if (j < nc) {
        // one chunk as the B operand: b0, b1 = (row g: k t, k t + 4)
        const float* x = xs + (j * kRows + g) * kXP + 8 * s + t;
        uint32_t xh0, xl0, xh1, xl1;
        split_tf32(x[0], xh0, xl0);
        split_tf32(x[4], xh1, xl1);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float* c = acc + (mt * kPassChunks + j) * 4;
          mma_tf32(c, wl[mt], xh0, xh1);
          mma_tf32(c, wh[mt], xl0, xl1);
          mma_tf32(c, wh[mt], xh0, xh1);
        }
      }
    }
  }
}

// The accumulators into the block's fp32 partial tile [row][column]. The
// m16n8 accumulator: c0, c1 = (column g, rows 2t, 2t + 1), c2, c3 =
// (column g + 8, rows 2t, 2t + 1), g = lane / 4, t = lane % 4.
__device__ __forceinline__ void write_partial(float* part,
                                              const float acc[kAcc], int nc) {
  const int lane = threadIdx.x & 31;
  const int col = 32 * (threadIdx.x >> 5) + (lane >> 2);
  const int row = 2 * (lane & 3);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < kPassChunks; ++j) {
      if (j < nc) {
        const float* c = acc + (mt * kPassChunks + j) * 4;
        float* p = part + (j * kRows + row) * kPartPitch + col + 16 * mt;
        p[0] = c[0];
        p[kPartPitch] = c[1];
        p[8] = c[2];
        p[kPartPitch + 8] = c[3];
      }
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
                const int32_t* __restrict__ gid, T* __restrict__ out, int M,
                int K, int N, int bm, int tiles_per_rank, int a_vec) {
  using G = Geom<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_chunk[kPassChunks];
  __shared__ int s_nc, s_cursor;

  coop::cluster_group cluster = coop::this_cluster();
  const int rank = blockIdx.x;            // the cluster spans grid x
  const int ranks = gridDim.x;
  const int n0 = blockIdx.y * kBlockN;
  const int g = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nchunks = M / kRows;
  const int ktiles = (K + G::kTileK - 1) / G::kTileK;
  const int t0 = rank * tiles_per_rank;
  const int nt = max(0, min(tiles_per_rank, ktiles - t0));
  const T* bg = b + static_cast<int64_t>(g) * K * N + n0;
  float* part = reinterpret_cast<float*>(smem);

  int cursor = 0;
  for (;;) {
    // the next (up to) kPassChunks chunks of group g, from `cursor` on; every
    // block of the cluster finds the same ones
    if (warp == 0) {
      int n = 0, cur = cursor;
      while (n < kPassChunks && cur < nchunks) {
        const int c = cur + lane;
        const bool mine = c < nchunks && gid[c * kRows / bm] == g;
        const unsigned mask = __ballot_sync(0xffffffffu, mine);
        const int pos = n + __popc(mask & ((1u << lane) - 1u));
        if (mine && pos < kPassChunks) s_chunk[pos] = c;
        const int found = __popc(mask);
        if (n + found >= kPassChunks) {
          const int last = __reduce_max_sync(
              0xffffffffu, mine && pos == kPassChunks - 1 ? c : -1);
          cur = last + 1;
          n = kPassChunks;
        } else {
          n += found;
          cur += 32;
        }
      }
      if (lane == 0) {
        s_nc = n;
        s_cursor = cur;
      }
    }
    __syncthreads();
    const int nc = s_nc;
    cursor = s_cursor;
    if (nc == 0) break;
    const int nrows = nc * kRows;

    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nt) {
        unsigned char* st = smem + s * G::kStageBytes;
        load_b<T>(smem_u32(st), bg, (t0 + s) * G::kTileK, K, N);
        load_a<T>(st + G::kBBytes, a, s_chunk, nrows, (t0 + s) * G::kTileK,
                  K, a_vec);
      }
      cp_async_commit();
    }
    for (int t = 0; t < nt; ++t) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      const int tn = t + kStages - 1;   // into the slot tile t - 1 left
      if (tn < nt) {
        unsigned char* st = smem + (tn % kStages) * G::kStageBytes;
        load_b<T>(smem_u32(st), bg, (t0 + tn) * G::kTileK, K, N);
        load_a<T>(st + G::kBBytes, a, s_chunk, nrows, (t0 + tn) * G::kTileK,
                  K, a_vec);
      }
      cp_async_commit();
      compute_tile(acc, smem + (t % kStages) * G::kStageBytes, nc,
                   static_cast<T*>(nullptr));
    }
    cp_async_wait<0>();
    __syncthreads();

    // the block's partial into its shared memory; after the cluster's
    // barrier rank q adds rows q, q + S, ... of all S partials, in rank order
    write_partial(part, acc, nc);
    cluster.sync();
    for (int r = rank; r < nrows; r += ranks) {
      float sum = cluster.map_shared_rank(part, 0)[r * kPartPitch +
                                                   threadIdx.x];
      for (int p = 1; p < ranks; ++p)
        sum += cluster.map_shared_rank(part, p)[r * kPartPitch + threadIdx.x];
      const int64_t row = s_chunk[r / kRows] * kRows + r % kRows;
      store(out + row * N + n0 + threadIdx.x, sum);
    }
    // no block overwrites its ring (or leaves) while another reads it
    cluster.sync();
  }
}

// The shared-memory attributes of instance T: its dynamic shared memory
// above 48 KB, and the largest carveout, so four blocks fit an SM.
template <typename T>
cudaError_t set_attributes() {
  const auto kernel = gemm_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Geom<T>::kBytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
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
int launch(const void* a, const void* b, const void* gid, void* out, int M,
           int K, int N, int bm, int G, int cluster, int smem,
           cudaStream_t stream) {
  using Gm = Geom<T>;
  if (smem != Gm::kBytes || cluster < 1 || cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool ready = false;   // the attributes, once per instance
  if (!ready) {
    const cudaError_t err = set_attributes<T>();
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  const int ktiles = (K + Gm::kTileK - 1) / Gm::kTileK;
  const int tiles_per_rank = (ktiles + cluster - 1) / cluster;
  const int a_vec = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                    static_cast<int64_t>(K) * Gm::kElem % 16 == 0;
  cudaLaunchAttribute attr = cluster_attribute(cluster);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, N / kBlockN, G);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Gm::kBytes;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, gemm_kernel<T>, static_cast<const T*>(a),
      static_cast<const T*>(b), static_cast<const int32_t*>(gid),
      static_cast<T*>(out), M, K, N, bm, tiles_per_rank, a_vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int occupancy(int cluster, int* blocks_per_sm, int* clusters) {
  cudaError_t err = set_attributes<T>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, gemm_kernel<T>, kThreads, Geom<T>::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr = cluster_attribute(cluster);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Geom<T>::kBytes;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(clusters, gemm_kernel<T>, &cfg));
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; cluster: the K split (blocks of one
// cluster), smem: the wrapper's count of the dynamic shared memory, held
// against the source's. Returns a cudaError_t (0 = launched).
int coalesced_gemm_launch(const void* a, const void* b, const void* gid,
                          void* out, int M, int K, int N, int bm, int G,
                          int dtype, int cluster, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(a, b, gid, out, M, K, N, bm, G, cluster, smem, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, b, gid, out, M, K, N, bm, G, cluster,
                                 smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of one block for dtype (as above), in bytes (0 for
// another dtype): the wrapper's launch guard holds its own count against it.
int coalesced_gemm_smem_bytes(int dtype) {
  if (dtype == 0) return Geom<float>::kBytes;
  if (dtype == 1) return Geom<__nv_bfloat16>::kBytes;
  return 0;
}

// Blocks of one instance an SM holds, and clusters of `cluster` blocks the
// card holds at once (cudaOccupancy*). Returns a cudaError_t.
int coalesced_gemm_occupancy(int dtype, int cluster, int* blocks_per_sm,
                             int* clusters) {
  if (dtype == 0) return occupancy<float>(cluster, blocks_per_sm, clusters);
  if (dtype == 1)
    return occupancy<__nv_bfloat16>(cluster, blocks_per_sm, clusters);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* coalesced_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
