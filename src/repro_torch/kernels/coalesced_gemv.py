"""The matvec superkernel on Hopper: G matvecs in one CUDA launch.

Replaces the Pallas TPU kernel ``coalesced_gemv`` of the JAX package
(``src/repro/kernels/coalesced_gemv.py``). It computes the same function:
``out[g] = x[g] @ w[g]`` for x [G, K], w [G, K, N], fp32 accumulation with
IEEE fp32 FMAs, output in x's dtype. This is the distinct-weights regime of
the paper's §5.3 RNN/LSTM coalescing; G streams on ONE weight go through
``coalesced_gemm`` instead (``kernels/ops.coalesced_matvec`` decides).

The kernel (``csrc/coalesced_gemv.cu``) is bound by the bytes of w: each
weight element feeds one FMA. It streams w with 16-byte loads spread over
(g, column-tile) blocks, splits K across the row groups of a block and adds
their partial sums in a fixed order (deterministic output). The source's
header says more. It is its own kernel, not ``coalesced_gemm`` with one row
per 8-row tile: there are no m-tiles and no group ids.

Build and bind: ``kernels/build.py`` (nvcc for ``sm_90a`` at first use, into
the git-ignored ``build/``, loaded with ``ctypes``; a failed build raises).
On a CPU tensor the wrapper returns the plain PyTorch version
(``kernels/ref.py``); on a CUDA tensor it launches the kernel or raises.
``coalesced_gemv.launches`` counts launches.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.build import INT, PTR
from repro_torch.kernels.ref import coalesced_gemv_ref

# The kernel's geometry, passed to nvcc as -D defines (the source
# static_asserts what its code needs of it) and read by ``launch_config``.
THREADS = 512         # threads per block: 64 row groups split K
ROW_LANES = 8         # lanes sharing one k row: 8 x 16 B, one 128-byte line
UNROLL = 8            # 16-byte loads in flight per thread
CHUNK_K = 4096        # x elements staged in shared memory at a time
MAX_GRID_Y = 65535
LIBRARY = _build.Library(
    "coalesced_gemv",
    defines=(f"-DGV_THREADS={THREADS}", f"-DGV_ROW_LANES={ROW_LANES}",
             f"-DGV_UNROLL={UNROLL}", f"-DGV_CHUNK_K={CHUNK_K}"),
    entry_points=(("coalesced_gemv_launch",
                   (PTR, PTR, PTR, INT, INT, INT, INT, PTR)),))

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def tile_n(dtype: torch.dtype) -> int:
    """Output columns of one block: 16 bytes per lane, ROW_LANES lanes
    (32 in fp32, 64 in bf16)."""
    return ROW_LANES * (16 // dtype.itemsize)


@dataclasses.dataclass(frozen=True)
class LaunchConfig:
    grid: tuple
    threads: int


def launch_config(G: int, K: int, N: int, dtype: torch.dtype) -> LaunchConfig:
    """The kernel's launch for x [G, K] and w [G, K, N] of ``dtype``, or
    ``ValueError`` for a shape or type it does not take. The launch guard:
    it takes the place of the JAX package's block-divisibility assert, and
    ``coalesced_gemv`` calls it before every launch."""
    if dtype not in _DTYPES:
        raise ValueError(f"coalesced_gemv: dtype {dtype}; the kernel takes "
                         f"float32 or bfloat16")
    tn = tile_n(dtype)
    if N <= 0 or N % tn:
        raise ValueError(f"coalesced_gemv: N={N} must be a positive multiple "
                         f"of {tn} (one block's columns in {dtype})")
    if K <= 0 or G <= 0:
        raise ValueError(f"coalesced_gemv: G={G}, K={K} must be positive")
    if G > MAX_GRID_Y or K >= 1 << 31:
        raise ValueError(f"coalesced_gemv: grid ({N // tn}, {G}) or K={K} "
                         f"exceeds the card's launch limits")
    return LaunchConfig(grid=(N // tn, G), threads=THREADS)


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
    launch_config(G, K, N, x.dtype)
    built = _build.load(LIBRARY)
    out = torch.empty((G, N), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    built.check(built.lib.coalesced_gemv_launch(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), G, K, N,
        _DTYPES[x.dtype], stream))
    coalesced_gemv.launches += 1
    return out


coalesced_gemv.launches = 0
