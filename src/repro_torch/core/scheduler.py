"""Out-of-order, SLO-aware space-time scheduler (paper §5.2).

The scheduler owns the ready queue of declared ops across all streams and
decides, at each device-free instant, between:

  * DISPATCH — issue the best coalesced superkernel now;
  * WAIT     — deliberately delay (stagger) because the cost model predicts a
               better-packed superkernel within the earliest-deadline op's
               slack window (paper: "purposefully delays/staggers ill-fitting
               kernels for better coalescing at a (slightly) later time").

Deadline accounting is per-op: an op's *latest start* is its request deadline
minus the modeled critical-path time of everything still ahead of it in its
stream. EDF over latest-start drives priority. Ops whose request deadline has
already passed are *evicted* from the EDF anchor set (paper §5.2 evicts
degraded stragglers rather than letting them cascade misses onto healthy
requests) — they still execute, but only opportunistically inside whatever
group the healthy anchor forms, or once nothing on-time remains; each
demotion is counted in ``evictions``.

The engine/JIT feeds ``next_arrival_t`` (the next known future admission)
before every ``decide`` call; a WAIT is only ever issued for a strictly
future instant, so the caller's ``now = wait_until`` loop cannot livelock on
a stale or already-elapsed arrival time.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.clustering import group_ops_exact
from repro_torch.core.coalescer import Coalescer, SuperkernelPlan
from repro_torch.core.costmodel import CostModel
from repro_torch.core.kernelspec import KernelOp


@dataclasses.dataclass
class Decision:
    kind: str                      # "dispatch" | "wait" | "idle"
    plan: Optional[SuperkernelPlan] = None
    wait_until: float = 0.0


@dataclasses.dataclass
class SchedulerConfig:
    max_group: int = 64
    # minimum modeled benefit (seconds) required to justify waiting
    min_wait_gain_s: float = 2e-6
    # never wait longer than this even with infinite slack
    max_wait_s: float = 500e-6
    # target device fill: stop growing a group once it reaches this many tiles
    target_tiles: int = 0          # 0 -> device.num_units


class OoOScheduler:
    def __init__(self, cost: CostModel, coalescer: Coalescer,
                 cfg: SchedulerConfig = SchedulerConfig(), *,
                 device: int = 0):
        self.cost = cost
        self.coalescer = coalescer
        self.cfg = cfg
        # mesh placement: this scheduler instance owns ONE device's op pool
        # (its own ready queue, EDF anchor set and virtual-clock free
        # instant). Multi-device serving runs N of these side by side —
        # ``push`` asserts every op was placed here, so a placement bug
        # surfaces at admission rather than as a certifier hazard later.
        self.device = device
        self.ready: List[KernelOp] = []
        # per-stream remaining critical path (sum of modeled op times)
        self._stream_remaining: Dict[int, float] = {}
        # next expected arrival (the simulator/engine tells us)
        self.next_arrival_t: float = math.inf
        # SLO-aware eviction bookkeeping: streams demoted out of the EDF
        # anchor set because their deadline passed before they could start.
        # Ops that carry per-request identity (``KernelOp.req_deadlines``,
        # plumbed by the serving engine through the KernelProgram) are
        # accounted under ``("req", req_id)`` — exactly once per missed
        # request across all of its steps, including a straggler batched
        # next to healthy batchmates whose anchor deadline hides it. Raw
        # op streams without ids fall back to (stream, deadline) keys.
        # The set must persist for the scheduler's lifetime: successive
        # step programs of the same missed request re-push ops under the
        # same key, and purging it would double-count them. Growth is one
        # small tuple per missed request per session.
        self.evictions: int = 0
        self._demoted: Set[Tuple] = set()

    def _count_demotion(self, key: Tuple) -> None:
        if key not in self._demoted:
            self._demoted.add(key)
            self.evictions += 1

    def demoted_requests(self) -> Set[int]:
        """Request ids demoted (evicted) from EDF anchoring so far — the
        ``("req", rid)`` entries of the dedup set. The serving engine feeds
        these into the schedule certifier's conservation check: an admitted
        request must retire, appear here, or surface unfinished."""
        return {key[1] for key in self._demoted
                if len(key) == 2 and key[0] == "req"}

    # ------------------------------------------------------------------
    # queue management
    # ------------------------------------------------------------------
    def annotate_stream(self, ops: Sequence[KernelOp]) -> None:
        """Compute per-op latest-start deadlines for one stream's program.

        Cross-device collective charges (``KernelOp.collective_s``) are
        part of the critical path behind the op, so they tighten the
        latest start exactly like GEMM time."""
        suffix = 0.0
        times = [self.cost.gemm_time(op.shape) + op.collective_s
                 for op in ops]
        for op, t in zip(reversed(list(ops)), reversed(times)):
            suffix += t
            op.latest_start_t = op.deadline_t - suffix

    def push(self, ops: Sequence[KernelOp]) -> None:
        for op in ops:
            assert op.device == self.device, (
                f"op {op.op_id} placed on device {op.device} pushed to "
                f"device {self.device}'s pool")
            if math.isinf(op.latest_start_t):
                op.latest_start_t = op.deadline_t - (
                    self.cost.gemm_time(op.shape) + op.collective_s)
        self.ready.extend(ops)

    def pending(self) -> int:
        return len(self.ready)

    # ------------------------------------------------------------------
    # the decision procedure
    # ------------------------------------------------------------------
    def decide(self, now: float) -> Decision:
        if not self.ready:
            return Decision("idle")
        cfg = self.cfg
        target_tiles = cfg.target_tiles or self.cost.device.num_units

        # 0. SLO-aware eviction: ops whose request deadline has already
        #    passed are demoted out of the EDF anchor set so they cannot
        #    cascade misses onto healthy requests (paper §5.2). They still
        #    run — opportunistically inside the anchor's group, or alone once
        #    nothing on-time remains.
        on_time: List[KernelOp] = []
        for op in self.ready:
            # per-request accounting: any batched request whose own final
            # deadline has passed counts once, even when the op itself is
            # still on time because a healthy batchmate anchors its deadline
            for rid, dl in op.req_deadlines:
                if dl <= now:
                    self._count_demotion(("req", rid))
            if op.deadline_t <= now:
                if not op.req_deadlines:
                    self._count_demotion((op.stream_id, op.deadline_t))
                # ops with ids were already counted per request above
            else:
                on_time.append(op)

        # 1. EDF anchor: the earliest latest-start among on-time ops
        anchor = min(on_time or self.ready, key=lambda o: o.latest_start_t)

        # 2. its zero-padding coalescing group among ready ops
        groups = group_ops_exact(self.ready)
        akey = next(k for k, v in groups.items() if anchor in v)
        # order by urgency with missed stragglers last; anchor stays first
        group = sorted(groups[akey],
                       key=lambda o: (o.deadline_t <= now, o.latest_start_t))
        group = group[: cfg.max_group]
        plan = self.coalescer.plan(group)

        # 3. stagger decision: is the group under-filling the device, and
        #    does the anchor have slack to wait for more arrivals?
        tiles = sum(self.cost.tiles(s, plan.block) for s in plan.shapes)
        slack = anchor.latest_start_t - now
        wait_until = min(now + slack, self.next_arrival_t,
                         now + cfg.max_wait_s)
        # wait_until must be strictly in the future: a WAIT that does not
        # advance the caller's virtual clock (stale/elapsed next_arrival_t)
        # would livelock the dispatch loop.
        if (tiles < target_tiles and slack > 0 and wait_until > now
                and self.next_arrival_t < now + min(slack, cfg.max_wait_s)):
            # napkin check: modeled gain of one more same-shape problem
            probe = KernelOp(-1, -1, anchor.kind, anchor.shape)
            gain = self.coalescer.marginal_gain(group, probe)
            if gain > cfg.min_wait_gain_s:
                return Decision("wait", wait_until=wait_until)

        for op in plan.ops:
            self.ready.remove(op)
        return Decision("dispatch", plan=plan)

    # ------------------------------------------------------------------
    def drain(self, now: float = 0.0) -> List[SuperkernelPlan]:
        """Dispatch everything (no waiting) — used by tests and batch mode."""
        plans = []
        self.next_arrival_t = math.inf
        while self.ready:
            d = self.decide(now)
            assert d.kind == "dispatch" and d.plan is not None
            plans.append(d.plan)
            now += d.plan.est_time_s
        return plans
