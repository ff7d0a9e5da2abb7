"""Event-driven execution simulator for the three multiplexing regimes.

Reproduces the paper's comparisons on one modeled device:
  * time-only multiplexing (§4.1, Fig. 4)  — serialized kernels + context
    switch flushes;
  * space-only multiplexing (§4.2, Fig. 5) — concurrent uncoordinated
    streams with contention (progress-based simulation: active kernels share
    units/bandwidth, so their service rates change as tenants come and go —
    this is exactly the source of the paper's unpredictability);
  * OoO VLIW JIT (§5) — our scheduler: coalesced superkernels dispatched
    serially (on TPU the superkernel IS the spatial multiplexing).

The simulator is policy-faithful, not cycle-accurate: kernel latencies come
from the calibrated roofline cost model (core/costmodel.py). A copy of the
JAX package's ``core/simulator.py`` over this package's copied core: with
the ``TPUV5E`` or ``V100`` device its results equal the reference's; with
``H100`` they are the port's modelled regimes (spec-sheet rates, not
measurements).
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.coalescer import Coalescer
from repro_torch.core.costmodel import CostModel
from repro_torch.core.kernelspec import KernelOp, stream_program
from repro_torch.core.scheduler import OoOScheduler, SchedulerConfig


@dataclasses.dataclass
class Request:
    req_id: int
    stream_id: int
    arrival_t: float
    slo_s: float
    ops: List[KernelOp]

    @property
    def deadline_t(self) -> float:
        return self.arrival_t + self.slo_s


@dataclasses.dataclass
class SimResult:
    name: str
    latencies: Dict[int, float]              # req_id -> completion latency
    makespan: float
    useful_flops: float
    peak_flops: float
    slo_misses: int
    num_requests: int

    @property
    def mean_latency(self) -> float:
        v = list(self.latencies.values())
        return sum(v) / len(v) if v else 0.0

    def p(self, q: float) -> float:
        v = sorted(self.latencies.values())
        if not v:
            return 0.0
        return v[min(int(q * len(v)), len(v) - 1)]

    @property
    def throughput_rps(self) -> float:
        return self.num_requests / self.makespan if self.makespan else 0.0

    @property
    def utilization(self) -> float:
        return self.useful_flops / (self.makespan * self.peak_flops) \
            if self.makespan else 0.0

    @property
    def slo_attainment(self) -> float:
        return 1.0 - self.slo_misses / max(self.num_requests, 1)


def make_requests(streams: Sequence[Tuple[ModelConfig, float, Sequence[float]]],
                  batch: int = 1) -> List[Request]:
    """streams: (config, slo_s, arrival_times) per tenant."""
    reqs: List[Request] = []
    rid = 0
    for sid, (cfg, slo, arrivals) in enumerate(streams):
        for t in arrivals:
            ops = stream_program(cfg, sid, batch, arrival_t=t, slo_s=slo)
            reqs.append(Request(rid, sid, t, slo, ops))
            rid += 1
    return sorted(reqs, key=lambda r: r.arrival_t)


def _finalize(name: str, cost: CostModel, reqs: Sequence[Request],
              done_t: Dict[int, float], makespan: float) -> SimResult:
    lat = {r.req_id: done_t[r.req_id] - r.arrival_t for r in reqs}
    misses = sum(1 for r in reqs if done_t[r.req_id] > r.deadline_t)
    useful = sum(op.shape.flops for r in reqs for op in r.ops)
    return SimResult(name, lat, makespan, useful, cost.device.peak_flops,
                     misses, len(reqs))


# ---------------------------------------------------------------------------
# time-only multiplexing: FIFO serialized kernels (paper §4.1)
# ---------------------------------------------------------------------------

def simulate_time_mux(reqs: Sequence[Request], cost: CostModel) -> SimResult:
    switch_s = 10e-6
    now = 0.0
    done_t: Dict[int, float] = {}
    last_stream: Optional[int] = None
    # round-robin between streams op-by-op (the GPU context scheduler
    # interleaves contexts; each switch flushes the pipeline)
    queues: Dict[int, List[Request]] = {}
    for r in reqs:
        queues.setdefault(r.stream_id, []).append(r)
    progress: Dict[int, int] = {}
    active: List[Request] = []
    pending = sorted(reqs, key=lambda r: r.arrival_t)
    pi = 0
    while len(done_t) < len(reqs):
        while pi < len(pending) and pending[pi].arrival_t <= now:
            active.append(pending[pi]); pi += 1
        if not active:
            now = pending[pi].arrival_t
            continue
        # round-robin over active requests
        r = active.pop(0)
        i = progress.get(r.req_id, 0)
        if last_stream is not None and last_stream != r.stream_id:
            now += switch_s
        op = r.ops[i]
        now += cost.gemm_time(op.shape)
        last_stream = r.stream_id
        progress[r.req_id] = i + 1
        if i + 1 == len(r.ops):
            done_t[r.req_id] = now
        else:
            active.append(r)
    return _finalize("time-mux", cost, reqs, done_t, now)


# ---------------------------------------------------------------------------
# space-only multiplexing: concurrent streams with contention (paper §4.2)
# ---------------------------------------------------------------------------

def simulate_space_mux(reqs: Sequence[Request], cost: CostModel) -> SimResult:
    """Progress-based simulation. Each stream runs its op sequence on its own
    'virtual context'; at any instant K active contexts share the device and
    each active op's service rate is its isolated rate divided by the
    contention factor from the cost model."""
    per_stream: Dict[int, List[Request]] = {}
    for r in reqs:
        per_stream.setdefault(r.stream_id, []).append(r)
    for q in per_stream.values():
        q.sort(key=lambda r: r.arrival_t)

    # context state: (request, op index, remaining isolated-seconds)
    ctx: Dict[int, Optional[Tuple[Request, int, float]]] = {
        s: None for s in per_stream}
    done_t: Dict[int, float] = {}
    now = 0.0
    pending = sorted(reqs, key=lambda r: r.arrival_t)
    pi = 0

    def load_next(sid: int) -> None:
        q = per_stream[sid]
        while q and q[0].req_id in done_t:
            q.pop(0)
        if q and q[0].arrival_t <= now:
            r = q[0]
            ctx[sid] = (r, 0, cost.gemm_time(r.ops[0].shape, co_tenants=1))

    while len(done_t) < len(reqs):
        while pi < len(pending) and pending[pi].arrival_t <= now:
            pi += 1
        for sid in ctx:
            if ctx[sid] is None:
                load_next(sid)
        active = [s for s, c in ctx.items() if c is not None]
        if not active:
            if pi < len(pending):
                now = pending[pi].arrival_t
                continue
            break
        K = len(active)
        slowdown = K * (1.25 if K > 1 else 1.0)  # shared units + interference
        # block-scheduler anomalies (paper Fig. 5): deterministic per-stream
        # jitter, amplified at odd tenant counts where SM partitioning is
        # uneven. hash-based so runs are reproducible.
        jit_amp = cost.device.spatial_jitter * (1.5 if K % 2 == 1 and K > 1
                                                else 1.0)
        def stream_slow(s: int) -> float:
            if K <= 1:
                return slowdown
            h = ((s * 2654435761 + K * 40503) % 1000) / 1000.0
            return slowdown * (1.0 + jit_amp * h)

        # next completion among active ops, or next arrival
        t_next = min(ctx[s][2] * stream_slow(s) for s in active)  # type: ignore[index]
        if pi < len(pending):
            t_next = min(t_next, pending[pi].arrival_t - now)
        t_next = max(t_next, 0.0)
        for s in active:
            r, i, rem = ctx[s]  # type: ignore[misc]
            rem -= t_next / stream_slow(s)
            if rem <= 1e-15:
                if i + 1 == len(r.ops):
                    done_t[r.req_id] = now + t_next
                    ctx[s] = None
                else:
                    ctx[s] = (r, i + 1,
                              cost.gemm_time(r.ops[i + 1].shape, co_tenants=1))
            else:
                ctx[s] = (r, i, rem)
        now += t_next
    return _finalize("space-mux", cost, reqs, done_t, now)


# ---------------------------------------------------------------------------
# the OoO VLIW JIT (paper §5)
# ---------------------------------------------------------------------------

def simulate_vliw(reqs: Sequence[Request], cost: CostModel,
                  sched_cfg: SchedulerConfig = SchedulerConfig(),
                  max_group: int = 64) -> SimResult:
    coal = Coalescer(cost, max_group=max_group)
    sched = OoOScheduler(cost, coal, sched_cfg)
    done_t: Dict[int, float] = {}
    now = 0.0
    pending = sorted(reqs, key=lambda r: r.arrival_t)
    pi = 0
    # per-request: ops dispatch in order; index of the next to dispatch
    next_idx: Dict[int, int] = {r.req_id: 0 for r in reqs}
    inflight: Dict[int, Request] = {}

    def admit(r: Request) -> None:
        sched.annotate_stream(r.ops)
        sched.push([r.ops[0]])
        inflight[r.req_id] = r

    by_op: Dict[int, Request] = {}
    for r in reqs:
        for op in r.ops:
            by_op[op.op_id] = r

    while len(done_t) < len(reqs):
        while pi < len(pending) and pending[pi].arrival_t <= now:
            admit(pending[pi]); pi += 1
        sched.next_arrival_t = pending[pi].arrival_t if pi < len(pending) \
            else math.inf
        d = sched.decide(now)
        if d.kind == "idle":
            if pi < len(pending):
                now = pending[pi].arrival_t
                continue
            break
        if d.kind == "wait":
            now = max(d.wait_until, now + 1e-9)
            continue
        plan = d.plan
        now += plan.est_time_s
        # completion: release each op's successor in its request
        for op in plan.ops:
            r = by_op[op.op_id]
            i = next_idx[r.req_id] + 1
            next_idx[r.req_id] = i
            if i == len(r.ops):
                done_t[r.req_id] = now
            else:
                nxt = r.ops[i]
                nxt.arrival_t = now
                sched.push([nxt])
    return _finalize("vliw", cost, reqs, done_t, now)


POLICIES = {
    "time": simulate_time_mux,
    "space": simulate_space_mux,
    "vliw": simulate_vliw,
}
