"""Flash attention on Hopper (causal, optional sliding window), in CUDA C++.

Replaces the Pallas TPU kernel ``flash_attention`` of the JAX package
(``src/repro/kernels/flash_attention.py``). It computes the same function on
q, k, v [BH, S, D]: scale 1/sqrt(D), mask ``cols <= rows`` (causal) and
``cols > rows - window`` (window > 0) with masked scores filled with the
finite -2e38, online softmax with fp32 m, l and acc, output
``acc / max(l, 1e-30)`` in q's dtype. ``kernels/ops.windowed_attention``
wraps it for [B, H, S, D].

The kernel (``csrc/flash_attention.cu``) runs on the tensor cores through
``mma.sync`` and is bound by operations at the path's shapes. A block owns
one (bh, 64-row q tile), a warp 16 of its rows; k/v tiles stream through a
two-stage ``cp.async`` ring and the block skips the tiles the mask hides
from all its rows. bf16 runs bf16 MMAs with fp32 sums, and P V takes P as
two bf16 halves, ``P_hi = bf16(P)`` and ``P_lo = bf16(P - P_hi)``: P
rounded once would put ~4.5 % of the outputs outside one bf16 ulp. fp32
runs 3xTF32: each operand split as ``hi = rna(x)``, ``lo = rna(x - hi)``
and ``a_hi b_hi + a_hi b_lo + a_lo b_hi`` summed, where plain TF32 would
break the fp32 limit (tests/test_torch_attention.py emulates both). The
next step is ``wgmma`` with TMA copies; the source's header says more.
``MMA`` names each dtype's path. Shared memory is dynamic (up to 195 KB,
fp32 at D = 256); ``smem_bytes`` is the wrapper's count of it, and the
launch guard refuses what the card cannot give one block.

Build and bind: ``kernels/build.py`` (nvcc for ``sm_90a`` at first use, into
the git-ignored ``build/``, loaded with ``ctypes``; a failed build raises).
On a CPU tensor the wrapper returns the plain PyTorch version
(``kernels/ref.py``); on a CUDA tensor it launches the kernel or raises.
``flash_attention.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.build import INT, PTR
from repro_torch.kernels.ref import flash_attention_ref

# The kernel's geometry, passed to nvcc as -D defines (the source
# static_asserts what its code needs of it) and read by ``launch_config``.
BLOCK_Q = 64          # query rows per block: one 16-row MMA tile per warp
BLOCK_KV = 32         # keys per kv tile (in registers as the S tile)
STAGES = 2            # (k, v) tile pairs in the cp.async ring
WARPS = BLOCK_Q // 16  # warps per block (the source derives it the same way)
HEAD_DIMS = (32, 64, 128, 256)   # head dims the source compiles
MAX_SMEM = 232448     # bytes of shared memory one block may use (227 KB)
MAX_GRID_Y = 65535
LIBRARY = _build.Library(
    "flash_attention",
    defines=(f"-DFA_BLOCK_Q={BLOCK_Q}", f"-DFA_BLOCK_KV={BLOCK_KV}",
             f"-DFA_STAGES={STAGES}"),
    entry_points=(
        ("flash_attention_launch",
         (PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, ctypes.c_float, INT,
          PTR)),
        ("flash_attention_smem_bytes", (INT, INT))))

# the source's dtype codes, and the MMA path each dtype takes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MMA = {torch.float32: "3xtf32", torch.bfloat16: "bf16x2-splitP"}


def smem_bytes(D: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block at head dim D: the q tile and
    STAGES (k, v) tile pairs in ``dtype``, every row padded by 16 bytes."""
    row = D * dtype.itemsize + 16
    return row * (BLOCK_Q + 2 * STAGES * BLOCK_KV)


@dataclasses.dataclass(frozen=True)
class LaunchConfig:
    grid: tuple
    threads: int
    smem: int


def launch_config(BH: int, S: int, D: int,
                  dtype: torch.dtype) -> LaunchConfig:
    """The kernel's launch for q, k, v [BH, S, D] of ``dtype``, or
    ``ValueError`` for a shape or type it does not take. The launch guard:
    it takes the place of the JAX package's tile-divisibility assert (the
    kernel masks a ragged S itself), and ``flash_attention`` calls it before
    every launch."""
    if dtype not in DTYPE_CODES:
        raise ValueError(f"flash_attention: dtype {dtype}; the kernel takes "
                         f"float32 or bfloat16")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D}; the kernel is "
                         f"compiled for {HEAD_DIMS}")
    if S <= 0 or BH <= 0:
        raise ValueError(f"flash_attention: BH={BH}, S={S} must be positive")
    grid = (-(-S // BLOCK_Q), BH)
    if BH > MAX_GRID_Y or BH * S * D >= 1 << 62 or S * D >= 1 << 31:
        raise ValueError(f"flash_attention: grid {grid} at D={D} exceeds "
                         f"the card's launch limits")
    smem = smem_bytes(D, dtype)
    if smem > MAX_SMEM:
        raise ValueError(f"flash_attention: {smem} bytes of shared memory "
                         f"at D={D}, {dtype}; one block may use {MAX_SMEM}")
    return LaunchConfig(grid=grid, threads=32 * WARPS, smem=smem)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q, k, v: [BH, S, D] -> [BH, S, D] in q's dtype."""
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; expected "
                         f"three equal [BH, S, D] shapes")
    if window < 0:
        raise ValueError(f"flash_attention: window={window} < 0")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; q, k and v must match")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: operands on different devices")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.data_ptr() % 16:   # read with 16-byte loads
            raise ValueError(f"flash_attention: {name} is not 16-byte "
                             f"aligned")
    BH, S, D = q.shape
    launch_config(BH, S, D, q.dtype)
    built = _build.load(LIBRARY)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    built.check(built.lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, S, D,
        int(causal), int(window), 1.0 / (D ** 0.5), DTYPE_CODES[q.dtype],
        stream))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
