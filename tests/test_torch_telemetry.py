"""The serving loop's telemetry (core/telemetry.py) on the CPU: spans only
while tracing, a span site's cost with tracing off, request lifecycles
and their waits, the slot gauge log, the O(1) heartbeat, the live
``JitStats``, the epoch closed however the loop ends, and the spans on the
profiler's clock.

A tiny dense model (2 layers, d 64) serves every run; tenant "a" has one
decode slot, so its later requests wait for it.
"""
import math
import time

import pytest
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import telemetry
from repro_torch.core.telemetry import RECORDER
from repro_torch.models.model import Model
from repro_torch.serving import (FrontDoor, MonotonicClock, ServeRequest,
                                 ServingEngine, Tenant)

PHASES = ("engine.", "jit.", "graphs.")


@pytest.fixture(scope="module")
def model():
    cfg = ModelConfig(name="tiny", arch_type="dense", num_layers=2,
                      d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                      vocab_size=256, head_dim=16, rope_theta=10000.0,
                      norm_eps=1e-5, tie_embeddings=False)
    m = Model(cfg, param_dtype=torch.float32, device="cpu")
    return m, m.init(torch.Generator().manual_seed(0))


def _engine(model):
    m, p = model
    return ServingEngine([Tenant("a", m, p, cache_len=64, max_batch=1),
                          Tenant("b", m, p, cache_len=64, max_batch=2)],
                         mode="vliw", device="cpu")


def _door(n=6, new_tokens=3):
    """``n`` requests due at once, tenant "a" taking every other one and
    the last; each first token's host instant kept."""
    door = FrontDoor()
    first = {}
    for i in range(n):
        tenant = "a" if i % 2 == 0 or i == n - 1 else "b"
        door.submit(ServeRequest(i, tenant, 0.0, 20, new_tokens, 10.0),
                    on_token=lambda tok, t, i=i:
                    first.setdefault(i, telemetry.now()))
    door.close()
    return door, first


@pytest.fixture(autouse=True)
def _follow_profiler():
    RECORDER.follow_profiler()
    yield
    RECORDER.follow_profiler()


@pytest.fixture(scope="module")
def traced(model):
    """One served epoch under a CPU profiler: the engine, its report, the
    first-token instants, each heartbeat's stats beside the old scan's
    counts and the live JitStats, the profiler's events and the host
    interval of the run."""
    RECORDER.follow_profiler()
    eng = _engine(model)
    door, first = _door()
    beats = []

    def heartbeat(stats):
        reqs = [tk.request for tk in door.tickets.values()]
        scan = {"finished": sum(not math.isnan(r.finish_t) for r in reqs),
                "shed": sum(r.shed for r in reqs),
                "occupied": sum(len(t.active_slots())
                                for t in eng.tenants.values())}
        beats.append((stats, scan, eng.live_jit_stats()))

    t0 = telemetry.now()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        rep = eng.serve_forever(door, clock=MonotonicClock(),
                                on_stats=heartbeat, stats_interval_s=0.0)
    t1 = telemetry.now()
    return dict(eng=eng, rep=rep, first=first, beats=beats,
                events=list(prof.events()), t=(t0, t1))


def _spans(t0, t1):
    return RECORDER.spans_in(t0, t1)


def test_tracing_off_records_no_span_and_opens_no_profiler_range(
        model, monkeypatch):
    calls = []
    real = telemetry._profiler_range
    monkeypatch.setattr(telemetry, "_profiler_range",
                        lambda name: calls.append(name) or real(name))
    eng = _engine(model)
    door, _ = _door(n=3)
    t0 = telemetry.now()
    rep = eng.serve_forever(door, clock=MonotonicClock())
    assert rep.unfinished == 0
    assert _spans(t0, telemetry.now()) == [] and calls == []
    # enable() records spans without a profiler, still no profiler range
    telemetry.enable()
    door, _ = _door(n=3)
    t0 = telemetry.now()
    _engine(model).serve_forever(door, clock=MonotonicClock())
    names = {s.name for s in _spans(t0, telemetry.now())}
    assert {"engine.poll", "engine.admit", "jit.dispatch",
            "engine.readback", "engine.retire"} <= names
    assert calls == []


def test_a_span_site_costs_under_a_microsecond_with_tracing_off():
    RECORDER.disable()
    span, n = telemetry.span, 20000
    best = math.inf
    for _ in range(5):
        t = time.perf_counter()
        for _ in range(n):
            with span("engine.poll") as sp:
                if sp:
                    sp.set(group=1)
        best = min(best, (time.perf_counter() - t) / n)
    assert best < 1e-6, best


def test_lifecycle_stamps_are_ordered_and_slot_waits_counted(traced):
    rep, first = traced["rep"], traced["first"]
    assert rep.unfinished == 0
    lives = {r.req_id: RECORDER.requests[r.req_id] for r in rep.requests}
    for rid, life in lives.items():
        assert life.polled <= life.admitted <= first[rid] <= life.retired
        assert 0.0 <= life.wait_slots <= life.admitted - life.polled + 1e-9
    # tenant "b" has a slot for each of its requests
    assert all(lives[i].wait_slots == 0.0 for i in (1, 3))


def test_a_slot_wait_counts_through_the_decodes_in_flight(traced):
    """Tenant "a" has one slot: each later request of it waits for the
    slot while the request before it decodes, a decode program of "a" in
    flight almost throughout; that wait is slot time. It equals the
    seconds "a" had no free slot by the slot gauge log, from the request's
    poll to its own take of the slot (the last take before its admission
    stamp, which follows the take)."""
    log = [(t, v) for t, name, key, v, _ in RECORDER.gauges
           if name == "slots" and key == "a"]
    for i in (2, 4, 5):
        life = RECORDER.requests[i]
        take = max(t for t, v in log if v == 1 and t <= life.admitted)
        full = sum(max(0.0, min(t1, take) - max(t0, life.polled))
                   for (t0, v), (t1, _) in zip(log, log[1:]) if v >= 1)
        assert life.wait_slots == pytest.approx(full, abs=1e-6)
        assert life.wait_slots > 0.5 * (life.admitted - life.polled)


def test_slot_gauge_log_integrates_to_the_run_slot_seconds(traced):
    rep, (t0, t1) = traced["rep"], traced["t"]
    # from the epoch's start, which logs every tenant's slots
    t0 = min(t for t, name, key, _, _ in RECORDER.gauges
             if name == "slots" and key in ("a", "b") and t >= t0)
    occupied, total = RECORDER.gauge_seconds("slots", t0, t1,
                                             keys={"a", "b"})
    implied = sum(RECORDER.requests[r.req_id].retired
                  - RECORDER.requests[r.req_id].admitted
                  for r in rep.requests)
    # the gauge steps and the lifecycle stamps lie microseconds apart
    assert occupied == pytest.approx(implied, abs=1e-3)
    assert total == pytest.approx(3 * (t1 - t0), rel=1e-9)
    waiting, _ = RECORDER.gauge_seconds("waiting", t0, t1, keys={0})
    assert waiting > 0.0


def test_heartbeat_counts_equal_the_old_scan(traced):
    beats = traced["beats"]
    assert len(beats) > 3
    for stats, scan, live in beats:
        assert {k: stats[k] for k in scan} == scan
        assert stats["submitted"] == 6 and stats["slots"] == 3
        assert stats["mean_group"] == live.groups.mean
    assert beats[-1][0]["finished"] == 6


def test_live_jit_stats_just_before_close_equal_the_folded(traced):
    eng, beats = traced["eng"], traced["beats"]
    # the last heartbeat ran on the loop's last pass
    assert beats[-1][2] == eng.jit_stats
    assert eng.jit_stats.superkernels > 0
    assert eng.live_jit_stats() == eng.jit_stats


def test_an_exception_from_the_heartbeat_closes_the_epoch(model):
    eng = _engine(model)
    door, _ = _door(new_tokens=8)

    def heartbeat(stats):
        if stats["finished"] or eng.live_jit_stats().superkernels > 4:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        eng.serve_forever(door, clock=MonotonicClock(), on_stats=heartbeat,
                          stats_interval_s=0.0)
    assert eng.jit_stats.superkernels > 4
    assert eng.last_report.unfinished > 0
    assert eng.live_jit_stats() == eng.jit_stats


def test_stop_at_the_door_leaves_at_the_next_pass(model):
    eng = _engine(model)
    door, _ = _door(new_tokens=8)
    passes = []

    def heartbeat(stats):
        passes.append(stats["t"])
        if eng.live_jit_stats().superkernels >= 2:
            door.stop()

    rep = eng.serve_forever(door, clock=MonotonicClock(),
                            on_stats=heartbeat, stats_interval_s=0.0)
    assert door.stopped and door.closed(0.0)
    assert rep is eng.last_report and rep.unfinished > 0
    assert eng.jit_stats.superkernels == 2 and len(passes) == 2


def test_an_engine_serves_a_second_epoch_after_a_stop(model):
    """The stopped epoch's unfinished requests give their slots back: the
    next epoch on the same engine starts with every slot free and serves
    the same tokens as a fresh engine."""
    eng = _engine(model)
    door, _ = _door(new_tokens=8)

    def heartbeat(stats):
        if eng.live_jit_stats().superkernels >= 2:
            door.stop()

    eng.serve_forever(door, clock=MonotonicClock(), on_stats=heartbeat,
                      stats_interval_s=0.0)
    assert all(not t.active_slots() for t in eng.tenants.values())
    assert eng._live_stats(eng._open_loop(), [], 0.0)["occupied"] == 0
    again = eng.serve_forever(_door()[0], clock=MonotonicClock())
    assert again.unfinished == 0
    fresh = _engine(model).serve_forever(_door()[0], clock=MonotonicClock())
    assert [r.tokens_out for r in again.requests] == \
        [r.tokens_out for r in fresh.requests]


def test_top_level_spans_share_the_profiler_clock(traced):
    t0, t1 = traced["t"]
    ring = [s for s in _spans(t0, t1) if s.parent is None]
    prof = sorted((e for e in traced["events"] if e.cpu_parent is None
                   and e.name.startswith(PHASES)),
                  key=lambda e: e.time_range.start)
    assert len(ring) > 20
    assert [s.name for s in ring] == [e.name for e in prof]
    # function scope (0), not a user annotation: a user range would lay a
    # gpu_user_annotation over the device timeline
    assert {e.scope for e in prof} == {0}
    offsets = [(e.time_range.start * 1e-6 - s.t0,
                e.time_range.end * 1e-6 - s.t1) for s, e in zip(ring, prof)]
    base = sorted(a for a, _ in offsets)[len(offsets) // 2]
    devs = sorted((max(abs(a - base), abs(b - base)), i, s.name)
                  for i, ((a, b), s) in enumerate(zip(offsets, ring)))
    assert devs[-1][0] < 2e-4, (len(devs), devs[-5:])
