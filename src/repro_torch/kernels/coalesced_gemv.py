"""The matvec superkernel on Hopper: G matvecs in one CUDA launch.

Replaces the Pallas TPU kernel ``coalesced_gemv`` of the JAX package
(``src/repro/kernels/coalesced_gemv.py``). It computes the same function:
``out[g] = x[g] @ w[g]`` for x [G, K], w [G, K, N], fp32 accumulation with
IEEE fp32 FMAs, output in x's dtype. This is the distinct-weights regime of
the paper's §5.3 RNN/LSTM coalescing; G streams on ONE weight go through
``coalesced_gemm`` instead (``kernels/ops.coalesced_matvec`` decides).

The kernel (``csrc/coalesced_gemv.cu``) is bound by the bytes of w: each
weight element feeds one FMA. A block owns one problem g, one tile of 128
bytes of output columns and one share of K; the S shares of one (tile, g)
are the blocks of one thread block cluster, so a launch at small G still
holds several blocks an SM. Rank q takes rounds q, q + S, ... of K, a
round being one k row for each row group. Each thread starts UNROLL
16-byte loads of w (and of the x elements they meet) before its first FMA;
the row groups' sums are added by warp shuffles, then across warps, then
across the cluster's ranks in rank order through distributed shared
memory: one launch, no workspace, no atomics. The split is a function of K alone (``k_split``),
so a problem's output bits do not depend on what else was coalesced with
it. The source's header says more.

Build and bind: ``kernels/build.py`` (nvcc for ``sm_90a`` at first use, into
the git-ignored ``build/``, loaded with ``ctypes``; a failed build raises).
On a CPU tensor the wrapper returns the plain PyTorch version
(``kernels/ref.py``); on a CUDA tensor it launches the kernel or raises.
``coalesced_gemv.launches`` counts launches.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.build import INT, PTR
from repro_torch.kernels.ref import coalesced_gemv_ref

# The kernel's geometry, passed to nvcc as -D defines (the source
# static_asserts what its code needs of it) and read by ``launch_config``.
# THREADS, UNROLL and RANK_ROWS are the best of a sweep on the H100
# (experiments/torch_gemv_sweep.py, results in PERF.md) over 128/256/512
# threads, 2/4/8 loads and 256..1024 rows a rank, among the splits that
# keep at least four blocks an SM at the LSTM shape's G = 2 in bf16.
THREADS = 256         # threads per block: 32 row groups
ROW_LANES = 8         # lanes sharing one k row: 8 x 16 B, one 128-byte line
UNROLL = 4            # 16-byte loads of w in flight per thread
MAX_CLUSTER = 8       # blocks a cluster at most (the portable limit)
RANK_ROWS = 448       # k rows of one cluster rank, before MAX_CLUSTER caps
                      # the split: 5 ranks at K 2048, 8 at K 4096
MAX_GRID_YZ = 65535
LIBRARY = _build.Library(
    "coalesced_gemv",
    defines=(f"-DGV_THREADS={THREADS}", f"-DGV_ROW_LANES={ROW_LANES}",
             f"-DGV_UNROLL={UNROLL}", f"-DGV_MAX_CLUSTER={MAX_CLUSTER}"),
    entry_points=(("coalesced_gemv_launch",
                   (PTR, PTR, PTR, INT, INT, INT, INT, INT, PTR)),
                  ("coalesced_gemv_occupancy", (INT, INT, PTR, PTR))))

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def tile_n(dtype: torch.dtype) -> int:
    """Output columns of one block: 16 bytes per lane, ROW_LANES lanes
    (32 in fp32, 64 in bf16)."""
    return ROW_LANES * (16 // dtype.itemsize)


def row_groups() -> int:
    """Row groups of one block: the rows a block takes in one round."""
    return THREADS // ROW_LANES


def k_split(K: int, dtype: torch.dtype) -> int:
    """Cluster size (ranks) for depth K: a function of K and the kernel's
    geometry only (a rank's rows are 128-byte lines of w in either dtype),
    so a problem's summation order is the same whatever G and N it was
    launched with. One rank for every RANK_ROWS rows of K, at most
    MAX_CLUSTER, and never more ranks than rounds of the row groups (every
    rank has rows); rank q takes rounds q, q + S, ... of K."""
    if dtype not in DTYPE_CODES:
        raise ValueError(f"coalesced_gemv: dtype {dtype}; the kernel takes "
                         f"float32 or bfloat16")
    rounds = -(-K // row_groups())
    return min(MAX_CLUSTER, -(-K // RANK_ROWS), rounds)


@dataclasses.dataclass(frozen=True)
class LaunchConfig:
    grid: tuple              # (cluster, N / tile_n, G)
    cluster: int             # blocks of one cluster: the K split
    threads: int


@functools.lru_cache(maxsize=1024)
def launch_config(G: int, K: int, N: int, dtype: torch.dtype) -> LaunchConfig:
    """The kernel's launch for x [G, K] and w [G, K, N] of ``dtype``, or
    ``ValueError`` for a shape or type it does not take. The launch guard:
    it takes the place of the JAX package's block-divisibility assert, and
    ``coalesced_gemv`` calls it before every launch."""
    if dtype not in DTYPE_CODES:
        raise ValueError(f"coalesced_gemv: dtype {dtype}; the kernel takes "
                         f"float32 or bfloat16")
    tn = tile_n(dtype)
    if N <= 0 or N % tn:
        raise ValueError(f"coalesced_gemv: N={N} must be a positive multiple "
                         f"of {tn} (one block's columns in {dtype})")
    if K <= 0 or G <= 0:
        raise ValueError(f"coalesced_gemv: G={G}, K={K} must be positive")
    cluster = k_split(K, dtype)
    grid = (cluster, N // tn, G)
    if grid[1] > MAX_GRID_YZ or grid[2] > MAX_GRID_YZ or K >= 1 << 30:
        raise ValueError(f"coalesced_gemv: grid {grid} or K={K} exceeds the "
                         f"card's launch limits")
    return LaunchConfig(grid=grid, cluster=cluster, threads=THREADS)


def coalesced_gemv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [G, K] packed vectors; w: [G, K, N] per-problem weights -> [G, N]
    in x's dtype."""
    G, K = x.shape
    G2, K2, N = w.shape
    if (G, K) != (G2, K2):
        raise ValueError(f"coalesced_gemv: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} disagree")
    if x.device.type == "cpu":
        return coalesced_gemv_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"coalesced_gemv: no kernel for device {x.device}")
    if w.dtype != x.dtype:
        raise TypeError(f"coalesced_gemv: dtypes {x.dtype}/{w.dtype}; x and "
                        f"w must match")
    if w.device != x.device:
        raise ValueError("coalesced_gemv: operands on different devices")
    for name, t in (("x", x), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"coalesced_gemv: {name} must be contiguous")
    if w.data_ptr() % 16:        # w is read with 16-byte loads
        raise ValueError("coalesced_gemv: w is not 16-byte aligned")
    cfg = launch_config(G, K, N, x.dtype)
    built = _build.load(LIBRARY)
    out = torch.empty((G, N), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    built.check(built.lib.coalesced_gemv_launch(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), G, K, N,
        DTYPE_CODES[x.dtype], cfg.cluster, stream))
    coalesced_gemv.launches += 1
    return out


coalesced_gemv.launches = 0
