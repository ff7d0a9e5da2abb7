"""Synthetic serving workloads: tenants, arrival processes, request traces."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class ServeRequest:
    req_id: int
    tenant: str
    arrival_t: float
    prompt_len: int
    max_new_tokens: int
    slo_s: float
    # SLO tier (index into the engine's TierSpec ladder, 0 = most urgent).
    # The front door's admission controller may DEGRADE a request to a
    # lower tier (relaxing slo_s, recording the original in
    # ``degraded_from``) or SHED it outright instead of admitting it.
    tier: int = 0
    # filled by the engine:
    finish_t: float = float("nan")
    tokens_out: Optional[List[int]] = None
    shed: bool = False
    degraded_from: Optional[int] = None

    @property
    def latency(self) -> float:
        return self.finish_t - self.arrival_t

    @property
    def met_slo(self) -> bool:
        # NaN finish_t (unfinished or shed) compares False: a request that
        # never finished did not meet its SLO
        return self.latency <= self.slo_s


def poisson_arrivals(rate_hz: float, n: int, rng: np.random.Generator,
                     start_t: float = 0.0) -> List[float]:
    gaps = rng.exponential(1.0 / rate_hz, size=n)
    return list(start_t + np.cumsum(gaps))


def bursty_arrivals(rate_hz: float, n: int, rng: np.random.Generator,
                    burst_factor: float = 5.0, p_burst: float = 0.2
                    ) -> List[float]:
    """MMPP-ish: occasional bursts at ``burst_factor``× the base rate —
    the paper's 'bursty arrival processes' (§7)."""
    out, t = [], 0.0
    for _ in range(n):
        r = rate_hz * (burst_factor if rng.random() < p_burst else 1.0)
        t += rng.exponential(1.0 / r)
        out.append(t)
    return out


def diurnal_arrivals(base_hz: float, peak_hz: float, period_s: float,
                     n: int, rng: np.random.Generator,
                     start_t: float = 0.0) -> List[float]:
    """Nonhomogeneous Poisson arrivals via thinning: the rate swings
    sinusoidally between ``base_hz`` (trough) and ``peak_hz`` (peak) with
    period ``period_s`` — the diurnal load curve the serving front door is
    gated on (time-average rate = (base + peak) / 2)."""
    out: List[float] = []
    t = start_t
    lam_max = max(base_hz, peak_hz)
    while len(out) < n:
        t += rng.exponential(1.0 / lam_max)
        lam = base_hz + (peak_hz - base_hz) * 0.5 * (
            1.0 - np.cos(2.0 * np.pi * (t - start_t) / period_s))
        if rng.random() * lam_max < lam:
            out.append(t)
    return out


def open_loop_trace(tenants: Sequence[str], rate_hz: float, n: int, *,
                    shape: str = "poisson",
                    tier_slo_s: Sequence[float] = (0.002, 0.004, 0.012),
                    tier_weights: Sequence[float] = (0.5, 0.3, 0.2),
                    prompt_len: int = 8, max_new_tokens: int = 4,
                    burst_factor: float = 5.0, period_s: Optional[float] = None,
                    seed: int = 0, rid0: int = 0) -> List[ServeRequest]:
    """Open-loop tiered trace for the serving front door: ONE merged
    arrival stream at ``rate_hz`` (arrivals keep coming regardless of
    completions — the sustained-load regime), split round-robin over
    ``tenants``; each request draws an SLO tier from ``tier_weights``
    (tier i carries deadline ``tier_slo_s[i]``). ``shape`` selects the
    arrival process: "poisson", "bursty" (MMPP) or "diurnal" (sinusoidal
    rate between 0.25x and 1.75x of ``rate_hz``, period ``period_s`` or
    the trace's natural span)."""
    rng = np.random.default_rng(seed)
    if shape == "poisson":
        arr = poisson_arrivals(rate_hz, n, rng)
    elif shape == "bursty":
        arr = bursty_arrivals(rate_hz, n, rng, burst_factor=burst_factor)
    elif shape == "diurnal":
        period = period_s if period_s is not None else n / rate_hz
        arr = diurnal_arrivals(0.25 * rate_hz, 1.75 * rate_hz, period, n,
                               rng)
    else:
        raise ValueError(f"unknown arrival shape {shape!r}")
    w = np.asarray(tier_weights, dtype=float)
    tiers = rng.choice(len(w), size=n, p=w / w.sum())
    return [ServeRequest(rid0 + i, tenants[i % len(tenants)], float(t),
                         prompt_len, max_new_tokens,
                         slo_s=float(tier_slo_s[tier]), tier=int(tier))
            for i, (t, tier) in enumerate(zip(arr, tiers))]


def two_wave_trace(wave1: Sequence[str], wave2: Sequence[str],
                   gap_s: float, *, prompt_len: int = 8,
                   max_new_tokens: int = 8, slo_s: float = 1.0
                   ) -> List[ServeRequest]:
    """Deterministic staged arrivals: one request per ``wave1`` tenant at
    t=0, one per ``wave2`` tenant at t=``gap_s``. The fixture for the
    stagger/WAIT regression tests — wave 2 lands inside wave 1's slack
    window, so an arrival-aware scheduler should delay under-filled
    dispatches to coalesce with it."""
    reqs: List[ServeRequest] = []
    for i, name in enumerate(wave1):
        reqs.append(ServeRequest(i, name, 0.0, prompt_len, max_new_tokens,
                                 slo_s))
    for j, name in enumerate(wave2):
        reqs.append(ServeRequest(len(wave1) + j, name, float(gap_s),
                                 prompt_len, max_new_tokens, slo_s))
    return reqs


def long_prompt_trace(tenants: Sequence[str], *, prompt_len: int = 256,
                      max_new_tokens: int = 4, slo_s: float = 10.0,
                      stagger_s: float = 0.0, n_per_tenant: int = 1,
                      prompt_jitter: int = 0, seed: int = 0
                      ) -> List[ServeRequest]:
    """Deterministic long-prompt multi-tenant trace — the prefill-coalescing
    fixture: every tenant submits ``n_per_tenant`` requests whose prompts
    dominate the work (``prompt_len`` >> ``max_new_tokens``), interleaved
    round-robin ``stagger_s`` apart so several tenants' prompt GEMMs are in
    flight together. ``prompt_jitter`` draws per-request lengths from
    [prompt_len - jitter, prompt_len] to exercise the prefill buckets."""
    rng = np.random.default_rng(seed)
    reqs: List[ServeRequest] = []
    rid = 0
    for wave in range(n_per_tenant):
        for name in tenants:
            plen = int(prompt_len - (rng.integers(0, prompt_jitter + 1)
                                     if prompt_jitter else 0))
            reqs.append(ServeRequest(rid, name, rid * stagger_s, plen,
                                     max_new_tokens, slo_s))
            rid += 1
    return reqs


def make_trace(tenants: Sequence[str], rate_hz: float, n_per_tenant: int,
               *, prompt_len: int = 32, max_new_tokens: int = 8,
               slo_s: float = 0.2, seed: int = 0, bursty: bool = False
               ) -> List[ServeRequest]:
    rng = np.random.default_rng(seed)
    reqs: List[ServeRequest] = []
    rid = 0
    for name in tenants:
        arr_fn = bursty_arrivals if bursty else poisson_arrivals
        for t in arr_fn(rate_hz, n_per_tenant, rng):
            reqs.append(ServeRequest(rid, name, float(t), prompt_len,
                                     max_new_tokens, slo_s))
            rid += 1
    return sorted(reqs, key=lambda r: r.arrival_t)
