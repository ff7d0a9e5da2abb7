"""The paper's superkernel on Hopper: a grouped GEMM written in CUDA C++.

Replaces the Pallas TPU kernel ``coalesced_gemm`` of the JAX package
(``src/repro/kernels/coalesced_gemm.py``). It computes the same function:
G heterogeneous GEMM problems, padded to one (K, N) envelope and
concatenated along m, run as ONE launch; ``group_ids`` maps each bm-row
m-tile to its weight matrix. fp32 or bf16 inputs, fp32 accumulation with
IEEE fp32 FMAs, output in A's dtype.

The kernel (``csrc/coalesced_gemm.cu``) is bound by the bytes of B it reads
at decode: a decode problem has a few rows, so each weight byte feeds only
a few FLOPs. Its design splits K across blocks so the B stream is spread
over the whole card, reads B with 16-byte (fp32) or 8-byte (bf16) coalesced
loads, and adds the K slices in a fixed order (deterministic output). The
source's header says more.

Build and bind: ``kernels/build.py`` compiles the CUDA source with ``nvcc``
for ``sm_90a`` at first use into a shared library under ``build/`` at the
repository root (git-ignored) and loads it with ``ctypes``. A failed build
raises; nothing falls back to the plain version.

On a CPU tensor the wrapper returns the plain PyTorch version
(``kernels/ref.py``); on a CUDA tensor it launches the kernel or raises.
``coalesced_gemm.launches`` counts launches and ``coalesced_gemm.max_groups``
records the largest G launched.

B is the packed weight operand the executor caches, identity-guarded on
the ORIGINAL weight tensors (``core/dispatch.py``): callers hand it the
same tensor objects every tick, and a weight hot-swap replaces tensors,
never ``copy_``s into them, which the guard could not see.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.build import INT, PTR
from repro_torch.kernels.ref import coalesced_gemm_ref

# The kernel's geometry. This is its one copy: the build passes it to nvcc
# as -D defines (csrc/coalesced_gemm.cu static_asserts what its code needs
# of it, shared memory included), and ``launch_config`` sizes the grid
# from it.
ROWS = 8              # rows of A per block; the packer's bm must be a multiple
BLOCK_N = 128         # output columns per block
CHUNK_K = 256         # depth of one K slice
THREADS = 256         # threads per block
REDUCE_THREADS = 256  # threads per block of the second (reduction) kernel
MAX_GRID_YZ = 65535
LIBRARY = _build.Library(
    "coalesced_gemm",
    defines=(f"-DCG_ROWS={ROWS}", f"-DCG_BLOCK_N={BLOCK_N}",
             f"-DCG_CHUNK_K={CHUNK_K}", f"-DCG_THREADS={THREADS}",
             f"-DCG_REDUCE_THREADS={REDUCE_THREADS}"),
    entry_points=(("coalesced_gemm_launch",
                   (PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, PTR)),))

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass(frozen=True)
class LaunchConfig:
    grid: tuple
    threads: int
    slices: int              # K slices = depth of the fp32 workspace


def launch_config(M: int, K: int, N: int, bm: int) -> LaunchConfig:
    """The kernel's launch for an [M, K] x [G, K, N] problem, or
    ``ValueError`` for a shape it does not take or a grid the card would
    refuse. The launch guard: it takes the place of the JAX package's VMEM
    check, and ``coalesced_gemm`` calls it before every launch. The block's
    threads and shared memory are fixed at build time and checked there."""
    if bm <= 0 or bm % ROWS:
        raise ValueError(f"coalesced_gemm: bm={bm} must be a positive "
                         f"multiple of {ROWS} (a block's rows must lie in "
                         f"one m-tile, i.e. one group)")
    if M <= 0 or M % bm:
        raise ValueError(f"coalesced_gemm: M={M} is not a multiple of "
                         f"bm={bm}")
    if N <= 0 or N % BLOCK_N:
        raise ValueError(f"coalesced_gemm: N={N} must be a positive "
                         f"multiple of {BLOCK_N}")
    if K <= 0:
        raise ValueError(f"coalesced_gemm: K={K} must be positive")
    slices = -(-K // CHUNK_K)
    grid = (M // ROWS, N // BLOCK_N, slices)
    if grid[1] > MAX_GRID_YZ or grid[2] > MAX_GRID_YZ \
            or grid[0] >= 1 << 31 or -(-M * N // REDUCE_THREADS) >= 1 << 31:
        raise ValueError(f"coalesced_gemm: grid {grid} exceeds the card's "
                         f"launch limits")
    return LaunchConfig(grid=grid, threads=THREADS, slices=slices)


def _check_operands(a: torch.Tensor, b: torch.Tensor,
                    gid: torch.Tensor) -> None:
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"coalesced_gemm: dtypes {a.dtype}/{b.dtype}; the "
                        f"kernel takes float32 or bfloat16, A and B alike")
    if gid.dtype != torch.int32:
        raise TypeError(f"coalesced_gemm: group_ids must be int32, got "
                        f"{gid.dtype}")
    if not (b.device == a.device == gid.device):
        raise ValueError("coalesced_gemm: operands on different devices")
    for name, t in (("A", a), ("B", b), ("group_ids", gid)):
        if not t.is_contiguous():
            raise ValueError(f"coalesced_gemm: {name} must be contiguous "
                             f"(a transposed view is not accepted)")
    if b.data_ptr() % 16:       # B is read with 16-byte (8-byte bf16) loads
        raise ValueError("coalesced_gemm: B is not 16-byte aligned")


def coalesced_gemm(a_packed: torch.Tensor, b_stacked: torch.Tensor,
                   group_ids: torch.Tensor, *, bm: int = 8) -> torch.Tensor:
    """Run the grouped superkernel.

    a_packed:  [M_pad, K]    problems concatenated along m (rows padded per
                             problem to multiples of ``bm``; pad rows zero);
    b_stacked: [G, K, N]     per-problem weight envelopes;
    group_ids: [M_pad // bm] int32 problem id per m-tile, each in [0, G).
    Returns [M_pad, N] in A's dtype; pad rows come back zero.
    """
    M, K = a_packed.shape
    G, K2, N = b_stacked.shape
    if K != K2 or M % bm or tuple(group_ids.shape) != (M // bm,):
        raise ValueError(f"coalesced_gemm: A {tuple(a_packed.shape)}, B "
                         f"{tuple(b_stacked.shape)}, group_ids "
                         f"{tuple(group_ids.shape)} at bm={bm}")
    if a_packed.device.type == "cpu":
        return coalesced_gemm_ref(a_packed, b_stacked, group_ids, bm)
    if a_packed.device.type != "cuda":
        raise ValueError(f"coalesced_gemm: no kernel for device "
                         f"{a_packed.device}")
    _check_operands(a_packed, b_stacked, group_ids)
    cfg = launch_config(M, K, N, bm)
    built = _build.load(LIBRARY)
    out = torch.empty((M, N), dtype=a_packed.dtype, device=a_packed.device)
    # the split-K workspace goes back to the caching allocator when this
    # function returns; the allocator is stream-ordered, so only later work
    # on this same stream can reuse it, after both kernels have run
    part = torch.empty((cfg.slices, M, N), dtype=torch.float32,
                       device=a_packed.device)
    stream = torch.cuda.current_stream(a_packed.device).cuda_stream
    err = built.lib.coalesced_gemm_launch(
        a_packed.data_ptr(), b_stacked.data_ptr(), group_ids.data_ptr(),
        part.data_ptr(), out.data_ptr(), M, K, N, bm,
        _DTYPES[a_packed.dtype], stream)
    built.check(err)
    coalesced_gemm.launches += 1
    coalesced_gemm.max_groups = max(coalesced_gemm.max_groups, G)
    return out


coalesced_gemm.launches = 0
coalesced_gemm.max_groups = 0
