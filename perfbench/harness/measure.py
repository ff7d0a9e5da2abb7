"""The yardstick's arithmetic: percentiles, the H100's published peaks, a
``coalesced_gemm`` launch's least time, the device's busy time from kernel
intervals, and the model FLOPs of served tokens.

Peaks: NVIDIA's H100 SXM data sheet, dense rates (the port's
``costmodel.H100`` holds the same spec-sheet values; copied here so the
program cannot move them): 989 TFLOP/s bf16 on the tensor cores and
3.35 TB/s of HBM3, at the full 700 W power limit.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0..100) of ALL values, linear between
    closest ranks (numpy's default); a missing value is passed as ``inf``
    and so counts as the slowest."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = int(math.floor(pos)), int(math.ceil(pos))
    if xs[hi] == math.inf:
        return math.inf if pos > lo or xs[lo] == math.inf else xs[lo]
    return xs[lo] + (pos - lo) * (xs[hi] - xs[lo])


def launch_least_s(M: int, K: int, N: int, G: int, itemsize: int) -> float:
    """The least time of one ``coalesced_gemm`` launch of A [M, K] against
    B [G, K, N] into C [M, N]: the larger of its FLOPs (each row against
    its group's B) over the bf16 peak and its bytes (A, B and C once each)
    over the HBM bandwidth."""
    flops = 2.0 * M * K * N
    moved = itemsize * (M * K + G * K * N + M * N)
    return max(flops / PEAK_BF16_FLOPS, moved / HBM_BYTES_PER_S)


def launches_least_s(launches: Dict[Tuple, int]) -> float:
    """Σ over ``{(M, K, N, G, dtype): count}`` of each launch's least time
    (the kernel wrapper's ``launches_by_shape``)."""
    total = 0.0
    for (M, K, N, G, dtype), count in launches.items():
        total += count * launch_least_s(M, K, N, G, dtype.itemsize)
    return total


def union_s(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def gaps(intervals: Iterable[Tuple[float, float]], t0: float,
         t1: float) -> List[Tuple[float, float]]:
    """The idle gaps of ``[t0, t1]`` that no interval covers."""
    out, cur = [], t0
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, t1)))
        cur = max(cur, e)
        if cur >= t1:
            break
    if cur < t1:
        out.append((cur, t1))
    return [(a, b) for a, b in out if b > a]


def idle_share(intervals: Sequence[Tuple[float, float]], t0: float,
               t1: float) -> float:
    """1 − (union of the kernel intervals inside ``[t0, t1]``) ÷ the window."""
    clipped = [(max(s, t0), min(e, t1)) for s, e in intervals
               if e > t0 and s < t1]
    return 1.0 - union_s(clipped) / (t1 - t0)


def token_flops(model: Dict, context: int) -> float:
    """Model FLOPs of one token at ``context`` positions of attention
    (itself included): 2 × the matmul parameters it reads (a MoE layer's
    router and its top-k experts), plus q·kᵀ and p·v over the context, in
    every layer, plus the unembedding."""
    d, L = model["hidden_size"], model["num_hidden_layers"]
    hd, H, Hkv = model["head_dim"], model["num_attention_heads"], \
        model["num_key_value_heads"]
    attn = d * H * hd * 2 + d * Hkv * hd * 2
    ffn = 3 * d * model["intermediate_size"]
    moe = model.get("moe")
    if moe:
        ffn = ffn * moe["num_experts_per_tok"] + d * moe["num_local_experts"]
    per_layer = 2 * (attn + ffn) + 4 * H * hd * context
    return L * per_layer + 2 * d * model["vocab_size"]


def prompt_flops(model: Dict, prompt_len: int) -> float:
    """Model FLOPs of a prompt pass: every position with its causal
    context, the unembedding once (the last position's logits)."""
    unembed = 2 * model["hidden_size"] * model["vocab_size"]
    per_pos = sum(token_flops(model, c) - unembed
                  for c in (1, prompt_len))        # linear in c: average
    return prompt_len * per_pos / 2 + unembed


def summary(values: Sequence[float]) -> Optional[Tuple[float, float, float]]:
    """(first quartile, median, third quartile) as Python's
    ``statistics.quantiles(values, n=4)`` gives them."""
    from statistics import quantiles
    if len(values) < 2:
        return None
    q1, q2, q3 = quantiles(values, n=4)
    return q1, q2, q3
