"""SLO-tiered admission control for the serving front door.

The port's copy of the JAX package's ``serving/admission.py``. It prices a
request with the engine's cost model (the spec-sheet ``H100`` by
default), which has no host term: on a host-bound card the real service
time can exceed the modelled cost several times over.

The engine's replay loop admits every request and lets EDF + eviction sort
out overload — under sustained open-loop traffic past the saturation knee
that degrades EVERY request together (queueing delay grows without bound,
attainment collapses toward zero). The front door instead makes an explicit
admit / degrade / shed decision per request AT ADMISSION, from the same
analytic cost model the scheduler plans with ("ML Inference Scheduling with
Predictable Latency", PAPERS.md):

  * the modeled service cost of the request (prefill + remaining decode
    steps, amortized at the tenant's batch width) is known up front;
  * the device's committed backlog (virtual completion horizon of
    everything already admitted to it) is tracked by the engine;
  * the ``ArrivalPredictor`` EWMA forecasts near-term load — when the
    offered utilization rho = cost / inter-arrival-gap exceeds 1, the
    queue is forecast to GROW during this request's service, so the
    admission bar tightens by the forecast growth.

A request is admitted iff its forecast completion (now + backlog + cost +
overload margin) meets its tier's deadline. When it cannot, the controller
walks DOWN the tier ladder (``TierSpec.slo_scale`` relaxes the deadline)
and degrades the request to the first tier whose deadline is feasible —
the request is still served, with a relaxed, *kept* promise — and only
sheds when no tier works. Shed requests never occupy a slot; they are
counted as SLO misses in ``ServeReport.slo_attainment`` (never silently
dropped from the denominator).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple

from repro_torch.serving.workload import ServeRequest


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One rung of the SLO ladder. ``slo_scale`` multiplies a request's
    base (tier-normalized) SLO budget; ``sheddable=False`` marks a tier
    the door must admit best-effort rather than shed (its misses then show
    up honestly in attainment)."""
    name: str
    slo_scale: float = 1.0
    sheddable: bool = True


DEFAULT_TIERS: Tuple[TierSpec, ...] = (
    TierSpec("interactive", 1.0),
    TierSpec("standard", 2.0),
    TierSpec("batch", 6.0),
)


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    action: str          # "admit" | "degrade" | "shed"
    tier: int            # final tier (== request tier unless degrading)
    slo_s: float         # final SLO budget at that tier
    eta_s: float         # forecast completion the decision was made on
    deadline_s: float    # deadline the request was judged against


@dataclasses.dataclass
class AdmissionController:
    """Predictable-latency admit/degrade/shed policy (front-door brain).

    ``decide`` is pure w.r.t. engine state — the engine supplies the
    modeled request cost, the device's committed backlog and the tenant's
    EWMA inter-arrival gap; the controller only applies the tier ladder.
    ``safety`` scales the overload-forecast margin (0 disables the
    ArrivalPredictor term, leaving a plain backlog-vs-deadline test).
    """

    tiers: Sequence[TierSpec] = DEFAULT_TIERS
    allow_degrade: bool = True
    safety: float = 1.0
    # door accounting (per ORIGINAL tier): admitted / degraded / shed
    counts: Dict[str, Dict[int, int]] = dataclasses.field(
        default_factory=lambda: {"admit": {}, "degrade": {}, "shed": {}})

    def _count(self, action: str, tier: int) -> None:
        self.counts[action][tier] = self.counts[action].get(tier, 0) + 1

    def decide(self, req: ServeRequest, now: float, backlog_s: float,
               cost_s: float, gap_s: float) -> AdmissionDecision:
        """Judge one due request at the door.

        ``backlog_s``: committed-but-unfinished modeled work ahead of it on
        its home device. ``gap_s``: the tenant's EWMA inter-arrival gap
        (inf until the predictor has seen a gap). The overload margin is
        max(rho - 1, 0) * cost_s: while this request is in service, rho
        * cost_s of new work is forecast to arrive, of which capacity
        absorbs cost_s — the excess is queue growth it must outlive."""
        tier = min(max(req.tier, 0), len(self.tiers) - 1)
        rho = cost_s / gap_s if (gap_s > 0.0 and math.isfinite(gap_s)) \
            else 0.0
        margin = max(rho - 1.0, 0.0) * cost_s * self.safety
        eta = now + backlog_s + cost_s + margin
        # tier-normalized base budget, so deadlines relax monotonically
        # down the ladder regardless of the tier the request entered at
        base = req.slo_s / self.tiers[tier].slo_scale
        last = len(self.tiers) if self.allow_degrade else tier + 1
        for j in range(tier, last):
            slo_j = base * self.tiers[j].slo_scale
            deadline = req.arrival_t + slo_j
            if eta <= deadline:
                action = "admit" if j == tier else "degrade"
                self._count(action, tier)
                return AdmissionDecision(action, j, slo_j, eta, deadline)
        deadline = req.arrival_t + req.slo_s
        if not self.tiers[tier].sheddable:
            # best-effort admit: the miss will be visible in attainment
            self._count("admit", tier)
            return AdmissionDecision("admit", tier, req.slo_s, eta, deadline)
        self._count("shed", tier)
        return AdmissionDecision("shed", tier, req.slo_s, eta, deadline)

    @property
    def n_shed(self) -> int:
        return sum(self.counts["shed"].values())

    @property
    def n_degraded(self) -> int:
        return sum(self.counts["degrade"].values())
