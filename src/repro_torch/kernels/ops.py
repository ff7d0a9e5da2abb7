"""Host-side packing for the superkernel, and the eager reference path.

This is the layer the JIT calls through: ``execute_superkernel`` takes a
planned group of (activation, weight) problems, pads them to the cluster
envelope, packs, launches ``coalesced_gemm`` and unpacks per-problem
results. The functions here are the **eager reference path**: every
dispatch re-pads and re-stacks its weight operands and pays exact
max-(K, N) envelopes. The serving hot path goes through
``core/dispatch.py``'s ``SuperkernelExecutor`` instead, which caches packed
weights persistently and buckets envelopes; this module stays the oracle
those fast paths are tested against.

``coalesced_matvec`` (the matvec regime: G streams on one weight go through
the GEMM superkernel, distinct weights through ``coalesced_gemv``) and
``windowed_attention`` (``flash_attention`` on [B, H, S, D]) are the eager
entry points of the other two kernels.

Launch guard
------------
``kernels/coalesced_gemm.launch_config`` takes the place of the JAX
package's VMEM guard, and the wrapper calls it before every launch. The
kernel's own resources are fixed when it is built (256 threads and 40 KB
of static shared memory per block, checked by the compiler), so what can
make the card refuse a launch is the shape: a packer ``bm`` that is not a
multiple of the kernel's 8-row block, an N that is not a multiple of its
128-column block, or a grid past the card's limits. The guard raises
``ValueError`` for those before the launch. On a CPU tensor there is no
launch.

Envelope bucketing policy (used by core/dispatch.py)
----------------------------------------------------
``envelope_bucket`` rounds a packed-dimension extent up to the next power of
two, floored at 128 — the same idea as ``prefill_bucket`` (core/jit.py)
applied to the superkernel envelope. The dispatch path buckets every
envelope extent (per-problem rows to ``bm`` multiples with a power-of-two
m-tile count, K and N through this function, the problem count G through
an unfloored power of two) so the set of distinct launch shapes stays
finite under group-shape churn. Bucket padding is zeros: zero activation
rows produce zero output rows (sliced off), zero K columns/rows add exact
``+0.0`` terms to the fp32 accumulator, zero N columns and zero-padded
weight slots are never read back — so any bucket ≥ the exact envelope is
correct. The padding is also bytes the kernel reads: an FFN width of 11008
becomes 16384 (1.49x the weight bytes).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.coalesced_gemm import coalesced_gemm
from repro_torch.kernels.coalesced_gemv import coalesced_gemv
from repro_torch.kernels.flash_attention import flash_attention


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def envelope_bucket(x: int, minimum: int = 128) -> int:
    """Power-of-two bucket for one packed-envelope extent (≥ ``minimum``)."""
    assert x >= 1, x
    return max(minimum, 1 << (x - 1).bit_length())


def _pad2(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Zero-pad a 2-D tensor at the bottom/right to [rows, cols]."""
    return F.pad(x, (0, cols - int(x.shape[1]), 0, rows - int(x.shape[0])))


@dataclasses.dataclass
class PackedGroup:
    """Host-side packing metadata for one superkernel dispatch."""
    a_packed: torch.Tensor           # [M_pad, K_pad]
    b_stacked: torch.Tensor          # [G, K_pad, N_pad]
    group_ids: torch.Tensor          # [M_pad // bm] int32
    row_slices: List[Tuple[int, int]]   # (start, real_m) per problem
    n_real: List[int]
    bm: int


def pack_problems(problems: Sequence[Tuple[torch.Tensor, torch.Tensor]], *,
                  bm: int = 128) -> PackedGroup:
    """Pad G (a [m,k], b [k,n]) problems to a common (K, N) envelope and
    concatenate the a's along m (per-problem m padded to a ``bm`` multiple)."""
    K = _round_up(max(int(a.shape[1]) for a, _ in problems), 128)
    N = _round_up(max(int(b.shape[1]) for _, b in problems), 128)
    a_parts, b_parts, gids, rows, n_real = [], [], [], [], []
    start = 0
    for g, (a, b) in enumerate(problems):
        m = int(a.shape[0])
        m_pad = _round_up(m, bm)
        a_parts.append(_pad2(a, m_pad, K))
        b_parts.append(_pad2(b, K, N))
        gids.extend([g] * (m_pad // bm))
        rows.append((start, m))
        n_real.append(int(b.shape[1]))
        start += m_pad
    device = problems[0][0].device
    return PackedGroup(
        a_packed=torch.cat(a_parts, dim=0),
        b_stacked=torch.stack(b_parts, dim=0),
        group_ids=torch.tensor(gids, dtype=torch.int32, device=device),
        row_slices=rows, n_real=n_real, bm=bm)


def execute_superkernel(problems: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                        *, bm: int = 128, shared_operand: bool = False
                        ) -> List[torch.Tensor]:
    """Coalesce and execute G GEMM problems; returns per-problem outputs.

    shared_operand=True (all problems share one weight matrix — the RNN/
    decode lockstep case) concatenates activations into a single GEMM so the
    weights stream through the kernel once.
    """
    if shared_operand:
        b = problems[0][1]
        ms = [int(a.shape[0]) for a, _ in problems]
        x = torch.cat([a for a, _ in problems], dim=0)
        m_pad = _round_up(int(x.shape[0]), bm)
        k_pad = _round_up(int(b.shape[0]), 128)
        n_pad = _round_up(int(b.shape[1]), 128)
        xp = _pad2(x, m_pad, k_pad)
        bp = _pad2(b, k_pad, n_pad).contiguous()
        out = coalesced_gemm(
            xp, bp[None],
            torch.zeros((m_pad // bm,), dtype=torch.int32, device=xp.device),
            bm=bm)
        outs, s = [], 0
        for m in ms:
            outs.append(out[s:s + m, :int(b.shape[1])])
            s += m
        return outs
    packed = pack_problems(problems, bm=bm)
    out = coalesced_gemm(packed.a_packed, packed.b_stacked, packed.group_ids,
                         bm=bm)
    return [out[s:s + m, :n] for (s, m), n in
            zip(packed.row_slices, packed.n_real)]


def coalesced_matvec(xs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor]
                     ) -> List[torch.Tensor]:
    """G matvecs (x [k], w [k, n]). Dispatches the shared-weight GEMM path
    when every problem uses the same weight tensor, else pads to a common
    (K, N) envelope (multiples of 128) and runs ``coalesced_gemv``."""
    if all(w is ws[0] for w in ws):
        outs = execute_superkernel([(x[None, :], ws[0]) for x in xs], bm=8,
                                   shared_operand=True)
        return [o[0] for o in outs]
    K = _round_up(max(int(w.shape[0]) for w in ws), 128)
    N = _round_up(max(int(w.shape[1]) for w in ws), 128)
    xp = torch.stack([F.pad(x, (0, K - int(x.shape[0]))) for x in xs])
    wp = torch.stack([_pad2(w, K, N) for w in ws])
    out = coalesced_gemv(xp, wp)
    return [out[i, :int(w.shape[1])] for i, w in enumerate(ws)]


def windowed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, window: int = 0) -> torch.Tensor:
    """[B, H, S, D] flash attention through the kernel (flattens B x H)."""
    B, H, S, D = q.shape
    out = flash_attention(*(t.reshape(B * H, S, D).contiguous()
                            for t in (q, k, v)),
                          causal=causal, window=window)
    return out.reshape(B, H, S, D)
