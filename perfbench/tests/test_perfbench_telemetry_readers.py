"""The readers of the program's telemetry (``repro_torch.core.telemetry``)
on a synthetic run: the right number from given records, None with none
in their window."""
import collections
import math

import pytest

from perfbench.harness import manifest
from perfbench.harness.serve import Run, Served
from perfbench.harness.traffic import Request
from repro_torch.core import telemetry
from repro_torch.core.telemetry import RECORDER, RequestLife, Span

NEW = ("queue_wait_p95_s", "slot_wait_p95_s", "slot_occupancy.offline",
       "mean_group.offline", "decode_body_ms.offline", "decode_body_ms.chat")
T = 1.0e6          # far from any real stamp of the process


def _run(mode):
    run = Run(workload={}, config={"model": {}}, mix={"mode": mode,
              "quiet_margin_s": 0.0}, seed=0, seconds=10.0, device=None,
              t_process=T - 100.0, t_window=(T, T + 10.0),
              t_profile=(T + 4.0, T + 6.0))
    run.counters = {"edges": {"p0": {"t": T + 4.0}, "p1": {"t": T + 6.0}}}
    return run


def _span(name, t0, parent=None, **attrs):
    sp = Span(RECORDER, name, attrs)
    sp.t0, sp.t1, sp.parent = t0, t0 + 0.01, parent
    return sp


@pytest.fixture
def records(monkeypatch):
    """The recorder's rings swapped for empty ones for the test."""
    monkeypatch.setattr(RECORDER, "spans", collections.deque())
    monkeypatch.setattr(RECORDER, "requests", collections.OrderedDict())
    monkeypatch.setattr(RECORDER, "gauges", collections.deque())
    return RECORDER


def test_perfbench_front_door_waits_from_the_lifecycles(records):
    run = _run("chat")
    # 20 requests due in the window before the sub-window: waits of
    # 0.1 · i s, slot waits of half that; the last never admitted
    for i in range(20):
        run.served[i] = Served(Request(i, 0, T + 0.1 * i, 16, 4),
                               due=T + 0.1 * i)
        life = RequestLife(i, "t0", T + 0.1 * i)
        if i < 19:
            life.admitted = life.polled + 0.1 * i
            life.wait_slots = 0.05 * i
        records.requests[i] = life
    waits = [0.1 * i for i in range(19)] + [math.inf]
    from perfbench.harness import measure
    assert manifest.reader("queue_wait_p95_s")(run) == pytest.approx(
        measure.percentile(waits, 95))
    assert manifest.reader("slot_wait_p95_s")(run) == pytest.approx(
        measure.percentile([w / 2 for w in waits], 95))
    # offline cells, or records older than the process, read nothing
    assert manifest.reader("queue_wait_p95_s")(_run("offline")) is None
    for life in records.requests.values():
        life.polled -= 1000.0
    assert manifest.reader("queue_wait_p95_s")(run) is None


def test_perfbench_slot_occupancy_integrates_the_gauge_log(records):
    run = _run("offline")
    # two tenants of 4 slots: t0 holds 2 from before the window to T + 5,
    # then 4; t1 holds 1 throughout; entries after the window are ignored
    records.gauges.extend([
        (T - 3.0, "slots", "t0", 2, 4), (T - 1.0, "slots", "t1", 1, 4),
        (T - 0.5, "waiting", 0, 7, 0), (T + 5.0, "slots", "t0", 4, 4),
        (T + 12.0, "slots", "t1", 0, 4)])
    want = 100.0 * (2 * 5 + 4 * 5 + 1 * 10) / (8 * 10)
    assert manifest.reader("slot_occupancy.offline")(run) == \
        pytest.approx(want)
    assert manifest.reader("slot_occupancy.offline")(_run("chat")) is None


def test_perfbench_dispatch_spans_give_group_and_body_time(records):
    run, chat = _run("offline"), _run("chat")
    d1 = _span("jit.dispatch", T + 4.1, group=4,
               device_ms=[("decode", 3.0)] * 4)
    d2 = _span("jit.dispatch", T + 4.2, group=2,
               device_ms=[("prefill", 9.0), ("decode", 5.0)])
    d3 = _span("jit.dispatch", T + 4.3, group=3,
               device_ms=[("decode", 50.0)] * 3)    # it captured a graph
    cap = _span("graphs.capture", T + 4.31, parent=d3.uid, kind="decode")
    outside = _span("jit.dispatch", T + 7.0, group=1,
                    device_ms=[("decode", 99.0)])
    step = _span("engine.step", T + 4.5, device_ms=[("decode", 7.0)])
    records.spans.extend([d1, d2, cap, d3, outside, step])
    assert manifest.reader("mean_group.offline")(run) == pytest.approx(3.0)
    body = (4 * 3.0 + 5.0 + 7.0) / 6
    assert manifest.reader("decode_body_ms.offline")(run) == \
        pytest.approx(body)
    assert manifest.reader("decode_body_ms.chat")(chat) == \
        pytest.approx(body)
    assert manifest.reader("decode_body_ms.chat")(run) is None
    assert manifest.reader("mean_group.offline")(chat) is None


def test_perfbench_new_readers_read_nothing_from_an_empty_run(records):
    records.spans.append(_span("jit.dispatch", T + 4.1, group=1,
                               device_ms=[("decode", 1.0)]))
    records.gauges.append((T + 1.0, "slots", "t0", 1, 1))
    for mode in ("offline", "chat"):
        run = Run(workload={}, config={"model": {}}, mix={"mode": mode},
                  seed=0, seconds=1.0, device=None, t_process=0.0,
                  t_window=(1.0, 2.0))
        for name in NEW:
            assert manifest.reader(name)(run) is None, (name, mode)
    assert telemetry.RECORDER is records
