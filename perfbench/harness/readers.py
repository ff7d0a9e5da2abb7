"""What the metric readers share: the window's tokens and requests, the
profiled sub-window's device time and the counters read at its edges."""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

from perfbench.harness import measure

GEMM_KERNEL = "gemm_kernel<"      # coalesced_gemm's device kernel


def ttfts(run) -> List[float]:
    """Due time to first token of every quiet request
    (``Run.quiet_requests``; inf for one that got none)."""
    return [s.instants[0] - s.due if s.instants else math.inf
            for s in run.quiet_requests()]


def sub_window(run) -> Optional[Tuple[float, float]]:
    """The profiled sub-window's host instants."""
    edges = run.counters.get("edges", {})
    if "p0" not in edges or "p1" not in edges:
        return None
    return edges["p0"]["t"], edges["p1"]["t"]


def decode_steps(run) -> int:
    """Decode-body executions (graph replays and captures) in the profiled
    sub-window."""
    edges = run.counters["edges"]
    d = (edges["p1"]["dispatch"] - edges["p0"]["dispatch"]).graphs_by_kind()
    return sum(d["decode"])


def launches(run) -> dict:
    """``coalesced_gemm`` launches by shape in the profiled sub-window."""
    edges = run.counters["edges"]
    a, b = edges["p0"]["launches"], edges["p1"]["launches"]
    return {k: n - a.get(k, 0) for k, n in b.items() if n > a.get(k, 0)}


def device_split(run) -> Optional[Tuple[float, float]]:
    """(coalesced_gemm device s, other device s) in the profiled window."""
    prof = run.profile
    if prof is None or not prof["device"]:
        return None
    gemm = other = 0.0
    for name, s, e in prof["device"]:
        if GEMM_KERNEL in name:
            gemm += e - s
        else:
            other += e - s
    return gemm, other


def window_flops(run, t0: float, t1: float) -> float:
    """Model FLOPs of the tokens delivered in ``[t0, t1]``: a first token
    carries its prompt pass, a later one its step at its context."""
    total = 0.0
    for s in run.served.values():
        for i, t in enumerate(s.instants):
            if not t0 <= t <= t1:
                continue
            if i == 0:
                total += measure.prompt_flops(run.model, s.req.prompt_len)
            else:
                total += measure.token_flops(run.model,
                                             s.req.prompt_len + i)
    return total
