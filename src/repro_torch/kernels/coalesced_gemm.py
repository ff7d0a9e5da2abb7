"""The paper's superkernel on Hopper: a grouped GEMM written in CUDA C++.

Replaces the Pallas TPU kernel ``coalesced_gemm`` of the JAX package
(``src/repro/kernels/coalesced_gemm.py``). It computes the same function:
G heterogeneous GEMM problems, padded to one (K, N) envelope and
concatenated along m, run as ONE launch; ``group_ids`` maps each bm-row
m-tile to its weight matrix. fp32 or bf16 inputs, fp32 accumulation, output
in A's dtype.

The kernel (``csrc/coalesced_gemm.cu``) is bound by the bytes of B it reads
at decode: a decode problem has a few rows, so each weight byte feeds only
a few FLOPs. A block owns one group, 128 output columns and one K range, and
applies each B tile it loads to every row of its group, so each B[g] is
streamed once per launch. B arrives through a ring of ``cp.async`` copies;
both dtypes run on the tensor cores (``mma.sync``, weights in the MMA's M
dimension): bf16 as bf16 MMAs, fp32 as 3xTF32 (each operand split into two
TF32 parts, three MMAs a product, about fp32's accuracy; plain TF32 would
not hold the fp32 tolerance). K is split across the blocks of a thread
block cluster, whose partial tiles are added in rank order through
distributed shared memory: one launch, no workspace. The split is a function
of K and the dtype alone (``k_split``), so a row's summation order does not
depend on what else was coalesced with it. The source's header says more.

Build and bind: ``kernels/build.py`` compiles the CUDA source with ``nvcc``
for ``sm_90a`` at first use into a shared library under ``build/`` at the
repository root (git-ignored) and loads it with ``ctypes``. A failed build
raises; nothing falls back to the plain version.

On a CPU tensor the wrapper returns the plain PyTorch version
(``kernels/ref.py``); on a CUDA tensor it launches the kernel or raises.
``coalesced_gemm.launches`` counts launches, ``coalesced_gemm.max_groups``
records the largest G launched, ``coalesced_gemm.launches_by_shape``
counts launches by (M, K, N, G, dtype) and ``coalesced_gemm.launches_by_bm``
by m-tile (the live tuner's ``bm`` where it reached the launch).

B is the packed weight operand the executor caches, identity-guarded on
the ORIGINAL weight tensors (``core/dispatch.py``): callers hand it the
same tensor objects every tick, and a weight hot-swap replaces tensors,
never ``copy_``s into them, which the guard could not see.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.build import INT, PTR
from repro_torch.kernels.ref import coalesced_gemm_ref

# The kernel's geometry. This is its one copy: the build passes it to nvcc
# as -D defines (csrc/coalesced_gemm.cu static_asserts what its code needs
# of it, shared memory included), and ``launch_config`` sizes the launch
# from it.
ROWS = 8              # rows of a chunk (one n8 MMA tile); bm % ROWS == 0
BLOCK_N = 128         # output columns per block: 32 per warp
THREADS = 128         # threads per block (the source requires BLOCK_N)
STAGES = 2            # k tiles in the cp.async ring (4 blocks an SM)
TILE_BYTES = 128      # bytes of k a row per k tile: 64 deep bf16, 32 fp32
PASS_CHUNKS = 8       # chunks (64 rows) a block adds up in one pass over B
MAX_CLUSTER = 8       # blocks a cluster at most (the portable limit)
RANK_TILES = 16       # k tiles (256 KB of a B panel) a cluster rank takes,
                      # before MAX_CLUSTER caps the split
MAX_SMEM = 232448     # bytes of shared memory one block may use (227 KB)
MAX_GRID_YZ = 65535
LIBRARY = _build.Library(
    "coalesced_gemm",
    defines=(f"-DCG_ROWS={ROWS}", f"-DCG_BLOCK_N={BLOCK_N}",
             f"-DCG_THREADS={THREADS}", f"-DCG_STAGES={STAGES}",
             f"-DCG_TILE_BYTES={TILE_BYTES}",
             f"-DCG_PASS_CHUNKS={PASS_CHUNKS}",
             f"-DCG_MAX_CLUSTER={MAX_CLUSTER}"),
    entry_points=(("coalesced_gemm_launch",
                   (PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, INT,
                    INT, PTR)),
                  ("coalesced_gemm_smem_bytes", (INT,)),
                  ("coalesced_gemm_occupancy", (INT, INT, PTR, PTR))))

# the source's dtype codes, and the MMA path each dtype takes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MMA = {torch.float32: "3xtf32", torch.bfloat16: "bf16"}


def k_tile(dtype: torch.dtype) -> int:
    """Depth of one k tile of ``dtype``."""
    return TILE_BYTES // dtype.itemsize


def smem_bytes(dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block: STAGES ring stages, each a B tile
    [k_tile][BLOCK_N] (rows padded by 16 bytes in bf16, 32 in fp32) and a
    pass's rows of A [ROWS * PASS_CHUNKS][k_tile] (padded by 16 bytes)."""
    pad = 16 if dtype.itemsize == 2 else 32
    b_tile = k_tile(dtype) * (BLOCK_N * dtype.itemsize + pad)
    a_tile = ROWS * PASS_CHUNKS * (TILE_BYTES + 16)
    return STAGES * (b_tile + a_tile)


def k_split(K: int, dtype: torch.dtype) -> tuple:
    """(cluster size, k tiles a rank) for depth K: a function of K and the
    dtype's geometry only, so a row's summation order is the same whatever
    M, N and G it was launched with. A rank streams RANK_TILES k tiles of
    its B panel (1024 k in bf16, 512 in fp32) unless MAX_CLUSTER ranks
    cannot cover K so."""
    tiles = -(-K // k_tile(dtype))
    cluster = min(MAX_CLUSTER, -(-tiles // RANK_TILES))
    return cluster, -(-tiles // cluster)


@dataclasses.dataclass(frozen=True)
class LaunchConfig:
    grid: tuple              # (cluster, N / BLOCK_N, G)
    cluster: int             # blocks of one cluster: the K split
    tiles_per_rank: int      # k tiles a cluster rank adds up
    threads: int
    smem: int                # dynamic shared memory of one block, bytes


@functools.lru_cache(maxsize=1024)
def launch_config(M: int, K: int, N: int, bm: int, G: int,
                  dtype: torch.dtype) -> LaunchConfig:
    """The kernel's launch for an [M, K] x [G, K, N] problem of ``dtype``,
    or ``ValueError`` for a shape it does not take or a launch the card
    would refuse. The launch guard: it takes the place of the JAX package's
    VMEM check, and ``coalesced_gemm`` calls it before every launch."""
    if dtype not in DTYPE_CODES:
        raise ValueError(f"coalesced_gemm: dtype {dtype}; the kernel takes "
                         f"float32 or bfloat16")
    if bm <= 0 or bm % ROWS:
        raise ValueError(f"coalesced_gemm: bm={bm} must be a positive "
                         f"multiple of {ROWS} (a chunk's rows must lie in "
                         f"one m-tile, i.e. one group)")
    if M <= 0 or M % bm:
        raise ValueError(f"coalesced_gemm: M={M} is not a multiple of "
                         f"bm={bm}")
    if N <= 0 or N % BLOCK_N:
        raise ValueError(f"coalesced_gemm: N={N} must be a positive "
                         f"multiple of {BLOCK_N}")
    if K <= 0 or G <= 0:
        raise ValueError(f"coalesced_gemm: K={K}, G={G} must be positive")
    cluster, tiles_per_rank = k_split(K, dtype)
    grid = (cluster, N // BLOCK_N, G)
    if grid[1] > MAX_GRID_YZ or grid[2] > MAX_GRID_YZ or M >= 1 << 31 \
            or K >= 1 << 31:
        raise ValueError(f"coalesced_gemm: grid {grid} exceeds the card's "
                         f"launch limits")
    smem = smem_bytes(dtype)
    if smem > MAX_SMEM:
        raise ValueError(f"coalesced_gemm: {smem} bytes of shared memory "
                         f"for {dtype}; one block may use {MAX_SMEM}")
    return LaunchConfig(grid=grid, cluster=cluster,
                        tiles_per_rank=tiles_per_rank, threads=THREADS,
                        smem=smem)


def _check_operands(a: torch.Tensor, b: torch.Tensor,
                    gid: torch.Tensor) -> None:
    if a.dtype not in DTYPE_CODES or b.dtype != a.dtype:
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
    if b.data_ptr() % 16:       # B is read with 16-byte copies
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
    dtype = a_packed.dtype
    cfg = launch_config(M, K, N, bm, G, dtype)
    built = _build.load(LIBRARY)
    out = torch.empty((M, N), dtype=dtype, device=a_packed.device)
    stream = torch.cuda.current_stream(a_packed.device).cuda_stream
    built.check(built.lib.coalesced_gemm_launch(
        a_packed.data_ptr(), b_stacked.data_ptr(), group_ids.data_ptr(),
        out.data_ptr(), M, K, N, bm, G, DTYPE_CODES[dtype], cfg.cluster,
        cfg.smem, stream))
    coalesced_gemm.launches += 1
    coalesced_gemm.max_groups = max(coalesced_gemm.max_groups, G)
    key = (M, K, N, G, dtype)
    shapes = coalesced_gemm.launches_by_shape
    shapes[key] = shapes.get(key, 0) + 1
    by_bm = coalesced_gemm.launches_by_bm
    by_bm[bm] = by_bm.get(bm, 0) + 1
    return out


coalesced_gemm.launches = 0
coalesced_gemm.max_groups = 0
coalesced_gemm.launches_by_shape = {}
coalesced_gemm.launches_by_bm = {}
