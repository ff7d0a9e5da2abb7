"""The one traffic generator: a mix file of parameters in, requests out.

A mix (``perfbench/traffic/<name>.json``) names its arrival process, its
length distributions, its tenant popularity and, for chat mixes, its SLO
tiers. Every seed gets the same multiset of sizes and gaps in another
order: the requests come in blocks of ``block``, and a block holds the
``block`` quantiles of each distribution (midpoint rule), each list shuffled
by the seed on its own. So any whole number of blocks does the same work
whatever the seed, and the seed only changes the order, the pairing of
prompt and output lengths, which tenant gets which request and the token
ids.

The arrival processes are those of the port's ``serving/workload.py``
(Poisson; MMPP bursts of ``burst_factor`` times the rate with probability
``p_burst``), drawn here from quantiles as above.
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    """One generated request. ``due_s`` is its due time relative to the
    start of the arrivals (0 for a backlog); ``tier`` indexes the mix's
    tiers (0 without tiers)."""
    rid: int
    tenant: int
    due_s: float
    prompt_len: int
    output_len: int
    tier: int = 0


def _quantiles(spec: Dict, n: int) -> np.ndarray:
    """The ``n`` midpoint quantiles of a length distribution, rounded and
    clipped to ``[min, max]``."""
    u = (np.arange(n) + 0.5) / n
    kind = spec["dist"]
    if kind == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(p)) for p in u])
        vals = spec["median"] * np.exp(spec["sigma"] * z)
    elif kind == "uniform":
        vals = spec["min"] + u * (spec["max"] - spec["min"])
    elif kind == "fixed":
        vals = np.full(n, float(spec["value"]))
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    lo = spec.get("min", 1)
    hi = spec.get("max", int(1e9))
    return np.clip(np.rint(vals), lo, hi).astype(np.int64)


def _counts(weights: Sequence[float], n: int) -> List[int]:
    """``n`` split by ``weights`` into whole counts that sum to ``n``
    (largest remainders)."""
    w = np.asarray(weights, dtype=float)
    raw = n * w / w.sum()
    base = np.floor(raw).astype(int)
    rest = np.argsort(-(raw - base), kind="stable")[:n - int(base.sum())]
    base[rest] += 1
    return [int(c) for c in base]


def _labels(weights: Sequence[float], n: int) -> np.ndarray:
    return np.repeat(np.arange(len(weights)), _counts(weights, n))


def _gaps(arrival: Dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` inter-arrival gaps (seconds) of one block."""
    kind = arrival["process"]
    if kind == "backlog":
        return np.zeros(n)
    u = (np.arange(n) + 0.5) / n
    unit = -np.log1p(-u)                       # Exp(1) quantiles
    rate = float(arrival["rate_rps"])
    if kind == "poisson":
        return rng.permutation(unit) / rate
    if kind == "bursty":
        # MMPP as serving/workload.bursty_arrivals: a share p_burst of the
        # gaps run at burst_factor times the rate
        burst = _labels((1.0 - arrival["p_burst"], arrival["p_burst"]), n)
        scale = np.where(burst == 1, arrival["burst_factor"], 1.0)
        return rng.permutation(unit) / (rate * rng.permutation(scale))
    raise ValueError(f"unknown arrival process {kind!r}")


def generate(mix: Dict, seed: int, n_requests: int) -> List[Request]:
    """``n_requests`` (rounded up to whole blocks) requests of ``mix`` for
    ``seed``, in due order. Request ids are their index."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed) & (2**63 - 1),
                                                        0x7472]))
    m = int(mix["block"])
    blocks = max(1, math.ceil(n_requests / m))
    prompts = _quantiles(mix["prompt_len"], m)
    outputs = _quantiles(mix["output_len"], m)
    tenants = _labels(mix["tenant_weights"], m)
    tiers = _labels(mix["tiers"]["weights"], m) if "tiers" in mix \
        else np.zeros(m, dtype=int)
    out: List[Request] = []
    t = 0.0
    for _ in range(blocks):
        p, o = rng.permutation(prompts), rng.permutation(outputs)
        te, ti = rng.permutation(tenants), rng.permutation(tiers)
        gaps = _gaps(mix["arrival"], m, rng)
        for i in range(m):
            t += float(gaps[i])
            out.append(Request(len(out), int(te[i]), t, int(p[i]), int(o[i]),
                               int(ti[i])))
    return out


def requests_for(mix: Dict, seconds: float) -> int:
    """How many requests a run of ``seconds`` draws: a backlog's fixed
    depth, or enough arrivals to cover the lead-in, the window and one
    block beyond."""
    if mix["arrival"]["process"] == "backlog":
        return int(mix["backlog_requests"])
    span = float(mix.get("lead_s", 0.0)) + seconds
    return int(math.ceil(span * float(mix["arrival"]["rate_rps"]))) \
        + int(mix["block"])


def distinct_prompt_lengths(mix: Dict) -> List[int]:
    """Every prompt length the mix can draw (a block's set)."""
    return sorted({int(x) for x in _quantiles(mix["prompt_len"],
                                              int(mix["block"]))})


def tier_limits(mix: Dict, tier: int) -> Optional[tuple]:
    """(TTFT limit, mean-gap limit) in seconds of a tier, or None for a mix
    without SLOs."""
    if "tiers" not in mix:
        return None
    scale = float(mix["tiers"]["scale"][tier])
    return (scale * float(mix["ttft_limit_s"]),
            scale * float(mix["gap_limit_s"]))
