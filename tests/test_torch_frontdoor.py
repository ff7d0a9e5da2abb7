"""The port's front door against the JAX package's, on the CPU: the daemon
(``serve_forever``), tiered admission control, token-streaming tickets and
the report's shed / tier accounting.

Tenants "a" (gemma3-1b smoke) and "b" (yi-9b smoke), fp32, the JAX
package's weights carried across with ``params_from_numpy`` and its
prompts through ``prompt_fn``; both engines on the same cost model
(``TPUV5E``) where their decisions are compared. Tolerances: tokens,
admit / degrade / shed decisions, tiers and ticket streams exact; modelled
times (request costs, SLO budgets, finish times) within 1e-12 relative,
and a daemon on a ``VirtualClock`` bitwise equal to ``run``. Every test
runs on the ``VirtualClock`` but one, which serves three requests on the
real clock and ends in about a second.
"""
import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core.costmodel import CostModel as JaxCostModel, TPUV5E as JTPU
from repro.models import Model as JaxModel
from repro.serving import AdmissionController as JaxAdmission
from repro.serving import ServingEngine as JaxEngine, Tenant as JaxTenant
from repro.serving import TierSpec as JaxTierSpec
from repro_torch.configs import smoke_config
from repro_torch.core.costmodel import CostModel, TPUV5E
from repro_torch.models import Model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import (AdmissionController, ArrivalPredictor,
                                 DoorClosed, FrontDoor, MonotonicClock,
                                 ServeReport, ServeRequest, ServingEngine,
                                 Tenant, TierSpec, VirtualClock,
                                 open_loop_trace)

REL = 1e-12


@pytest.fixture(scope="module")
def models():
    out = []
    for arch, seed in (("gemma3-1b", 1), ("yi-9b", 2)):
        jm = JaxModel(jax_smoke_config(arch), param_dtype=jnp.float32)
        jp = jm.init(jax.random.PRNGKey(seed))
        tm = Model(smoke_config(arch), param_dtype=torch.float32,
                   device="cpu")
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")
        out.append((jm, jp, tm, tp))
    return out


def _jax_prompt(cfg, req, rng=jax.random.PRNGKey(0)):
    return np.array(jax.random.randint(jax.random.fold_in(rng, req.req_id),
                                       (1, req.prompt_len), 0,
                                       cfg.vocab_size))


def _port(models, **kw):
    tenants = [Tenant(n, tm, tp, cache_len=32, max_batch=2)
               for n, (_, _, tm, tp) in zip("ab", models)]
    return ServingEngine(
        tenants, mode="vliw", cost=CostModel(TPUV5E), device="cpu",
        prompt_fn=lambda t, r: torch.from_numpy(_jax_prompt(t.cfg, r)), **kw)


def _ref(models, **kw):
    tenants = [JaxTenant(n, jm, jp, cache_len=32, max_batch=2)
               for n, (jm, jp, _, _) in zip("ab", models)]
    return JaxEngine(tenants, mode="vliw", cost=JaxCostModel(JTPU), **kw)


def _tokens(rep):
    return {r.req_id: tuple(r.tokens_out or ()) for r in rep.requests}


def _trace(n=4, rate=1e5, max_new=2, slo=1.0):
    return [ServeRequest(i, "ab"[i % 2], i / rate, 8, max_new, slo)
            for i in range(n)]


# ---------------------------------------------------------------------------
# admission control against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def overload(models):
    """One open-loop overload trace (~8x the modelled service rate, tiered
    SLOs scaled to the cost model) served with admission control by both
    engines, and without it by the port."""
    eng = _port(models, admission_control=True)
    cost = eng._request_cost_s(eng.tenants["a"],
                               ServeRequest(0, "a", 0.0, 8, 2, 1.0))
    trace = open_loop_trace(
        ["a", "b"], rate_hz=8.0 / cost, n=36, shape="poisson",
        tier_slo_s=(4 * cost, 8 * cost, 12 * cost), prompt_len=8,
        max_new_tokens=2, seed=7)
    jeng = _ref(models, admission_control=True)
    return dict(trace=trace, port=(eng, eng.run(trace)),
                ref=(jeng, jeng.run(trace)),
                all=_port(models).run(trace))


def test_request_cost_equals_reference(models):
    eng, jeng = _port(models), _ref(models)
    for name in "ab":
        for prompt, new in ((8, 2), (24, 5), (8, 1)):
            req = ServeRequest(0, name, 0.0, prompt, new, 1.0)
            assert eng._request_cost_s(eng.tenants[name], req) == \
                pytest.approx(jeng._request_cost_s(jeng.tenants[name], req),
                              rel=REL)


def test_admission_decisions_equal_reference(overload):
    (eng, rep), (jeng, jrep) = overload["port"], overload["ref"]

    def decisions(r):
        return (r.req_id, r.shed, r.tier, r.degraded_from)
    assert [decisions(r) for r in rep.requests] == \
        [decisions(r) for r in jrep.requests]
    assert [r.slo_s for r in rep.requests] == pytest.approx(
        [r.slo_s for r in jrep.requests], rel=REL)
    assert eng.admission.counts == jeng.admission.counts
    assert _tokens(rep) == _tokens(jrep)
    fin = [r.finish_t for r in rep.requests if not r.shed]
    jfin = [r.finish_t for r in jrep.requests if not r.shed]
    assert fin == pytest.approx(jfin, rel=REL)
    assert rep.tier_attainment() == jrep.tier_attainment()


def test_admission_sheds_under_overload_and_keeps_admitted_deadlines(
        overload):
    (eng, rep), rep_all = overload["port"], overload["all"]
    assert rep.shed > 0 and eng.admission.n_shed == rep.shed
    assert all(not r.met_slo and r.tokens_out is None
               for r in rep.requests if r.shed)
    assert rep.slo_attainment > rep_all.slo_attainment
    assert rep.goodput_rps > rep_all.goodput_rps
    admitted = [r for r in rep.requests if not r.shed]
    assert sum(r.met_slo for r in admitted) / len(admitted) > \
        rep_all.slo_attainment
    # admission changes who runs, never the tokens of what runs
    toks_all = _tokens(rep_all)
    for r in rep.requests:
        if r.tokens_out is not None:
            assert tuple(r.tokens_out) == toks_all[r.req_id]


@pytest.mark.parametrize("backlog,cost,gap", [
    (0.0, 0.1, math.inf), (1.5, 0.1, math.inf), (50.0, 0.1, math.inf),
    (0.85, 0.1, 0.01), (0.3, 0.2, 0.5), (3.0, 0.5, 0.1)])
@pytest.mark.parametrize("tier", [0, 1, 2])
def test_admission_controller_decides_as_reference(tier, backlog, cost, gap):
    req = ServeRequest(0, "a", 0.25, 8, 4, slo_s=1.0 * (2 ** tier),
                       tier=tier)
    got = AdmissionController().decide(req, 0.3, backlog, cost, gap)
    want = JaxAdmission().decide(req, 0.3, backlog, cost, gap)
    assert (got.action, got.tier) == (want.action, want.tier)
    assert (got.slo_s, got.eta_s, got.deadline_s) == pytest.approx(
        (want.slo_s, want.eta_s, want.deadline_s), rel=REL)


def test_admission_controller_tier_ladder():
    ctl = AdmissionController()
    req = ServeRequest(0, "a", 0.0, 8, 4, slo_s=1.0, tier=0)
    assert ctl.decide(req, 0.0, 0.0, 0.1, math.inf).action == "admit"
    d = ctl.decide(req, 0.0, 1.5, 0.1, math.inf)
    assert d.action == "degrade" and d.tier == 1
    assert d.slo_s == pytest.approx(2.0)
    assert ctl.decide(req, 0.0, 50.0, 0.1, math.inf).action == "shed"
    assert ctl.n_shed == 1 and ctl.n_degraded == 1
    assert ctl.decide(req, 0.0, 0.85, 0.1, 0.01).eta_s > 0.95


def test_admission_controller_unsheddable_tier_admits_best_effort():
    for ctl_cls, tier_cls in ((AdmissionController, TierSpec),
                              (JaxAdmission, JaxTierSpec)):
        ctl = ctl_cls(tiers=(tier_cls("gold", 1.0, sheddable=False),),
                      allow_degrade=False)
        req = ServeRequest(0, "a", 0.0, 8, 4, slo_s=0.1, tier=0)
        assert ctl.decide(req, 0.0, 99.0, 0.1, math.inf).action == "admit"


# ---------------------------------------------------------------------------
# the report and the arrival predictor
# ---------------------------------------------------------------------------

def test_report_counts_shed_as_misses():
    ok = ServeRequest(0, "a", 0.0, 4, 2, slo_s=1.0)
    ok.finish_t, ok.tokens_out = 0.5, [1, 2]
    shed = ServeRequest(1, "a", 0.0, 4, 2, slo_s=1.0, tier=0)
    shed.shed = True
    late = ServeRequest(2, "a", 0.0, 4, 2, slo_s=1.0, tier=1)
    late.finish_t, late.tokens_out = 5.0, [3, 4]
    rep = ServeReport("vliw", [ok, shed, late], modeled_time_s=1.0,
                      wall_time_s=0.0)
    assert rep.shed == 1 and rep.unfinished == 1
    assert rep.slo_attainment == pytest.approx(1.0 / 3.0)
    assert rep.goodput_rps == pytest.approx(1.0)
    assert rep.p_latency(1.0) == math.inf
    assert rep.tier_attainment() == {0: 0.5, 1: 0.0}
    assert rep.num_devices == 1 and rep.device_skew == 1.0


def test_tier_attainment_groups_degraded_by_original_tier():
    r = ServeRequest(0, "a", 0.0, 4, 2, slo_s=2.0, tier=1)
    r.degraded_from = 0
    r.finish_t, r.tokens_out = 1.0, [7]
    rep = ServeReport("vliw", [r], modeled_time_s=1.0, wall_time_s=0.0)
    assert rep.tier_attainment(original=True) == {0: 1.0}
    assert rep.tier_attainment(original=False) == {1: 1.0}


def test_arrival_predictor_folds_out_of_order_observations():
    pred = ArrivalPredictor(alpha=0.5)
    pred.observe("t", 0.0)
    pred.observe("t", 0.2)
    assert pred.gap("t") == pytest.approx(0.2)
    pred.observe("t", 0.1)
    assert pred.gap("t") == pytest.approx(0.5 * 0.1 + 0.5 * 0.2)
    pred.observe("t", 0.4)
    assert pred.gap("t") == pytest.approx(0.5 * 0.2 + 0.5 * 0.15)
    late = ArrivalPredictor(alpha=0.2)
    late.observe("t", 1.0)
    late.observe("t", 0.5)
    assert late.gap("t") == pytest.approx(0.5)
    assert late.predict(0.0) == pytest.approx(1.5)
    assert late.gap("unseen") == math.inf


def test_run_does_not_mutate_trace_and_reruns_identically(models):
    trace = _trace(n=4)
    eng = _port(models)
    rep1 = eng.run(trace)
    assert all(math.isnan(r.finish_t) and r.tokens_out is None
               and not r.shed for r in trace)
    rep2 = eng.run(trace)
    assert _tokens(rep1) == _tokens(rep2)
    assert all(len(t) == 2 for t in _tokens(rep1).values())


# ---------------------------------------------------------------------------
# the FrontDoor object
# ---------------------------------------------------------------------------

def test_front_door_lifecycle_and_guards():
    door = FrontDoor()
    t1 = door.submit(ServeRequest(0, "a", 0.0, 8, 2, 1.0), at=0.5)
    door.submit(ServeRequest(1, "a", 0.0, 8, 2, 1.0))       # live: due now
    with pytest.raises(ValueError, match="duplicate req_id"):
        door.submit(ServeRequest(0, "a", 0.0, 8, 2, 1.0))
    assert not door.finished(0.0)
    out = door.poll(0.0)
    assert [r.req_id for r in out] == [1] and out[0].arrival_t == 0.0
    assert door.next_arrival(0.0) == 0.5
    # the engine's per-device lookahead: only the submissions it accepts
    door.submit(ServeRequest(7, "b", 0.0, 8, 2, 1.0), at=0.7)
    assert door.next_arrival(0.0, where=lambda r: r.tenant == "b") == 0.7
    assert door.next_arrival(0.0, where=lambda r: r.tenant == "c") is None
    assert door.poll(0.7)[-1].req_id == 7
    assert t1.request.arrival_t == 0.5
    door.close()
    with pytest.raises(DoorClosed):
        door.submit(ServeRequest(2, "a", 0.0, 8, 2, 1.0))
    assert door.finished(0.5)


def test_front_door_deferred_close():
    door = FrontDoor()
    door.close(at=1.0)
    assert not door.closed(0.5)
    door.submit(ServeRequest(0, "a", 0.0, 8, 2, 1.0), at=2.0)
    assert door.closed(1.0)
    with pytest.raises(DoorClosed):
        door.submit(ServeRequest(1, "a", 0.0, 8, 2, 1.0))
    assert door.poll(2.0) != [] and door.finished(2.0)


# ---------------------------------------------------------------------------
# the daemon loop
# ---------------------------------------------------------------------------

def test_daemon_idles_across_gap_and_flushes_on_close(models):
    eng = _port(models, certify=True)
    door = FrontDoor()
    door.submit(ServeRequest(0, "a", 0.0, 8, 2, 1.0), at=0.0)
    door.submit(ServeRequest(1, "b", 0.0, 8, 2, 1.0), at=0.5)
    door.close(at=0.6)
    rep = eng.serve_forever(door, clock=VirtualClock())
    assert len(rep.requests) == 2
    assert rep.unfinished == 0 and rep.shed == 0
    assert all(len(r.tokens_out) == 2 for r in rep.requests)
    assert rep.requests[1].finish_t > 0.5 and rep.modeled_time_s > 0.5
    assert rep.jit.hazard_checks > 0 and rep.jit.hazard_violations == 0


def test_daemon_immediate_close_returns_empty_report(models):
    door = FrontDoor()
    door.close()
    rep = _port(models).serve_forever(door, clock=VirtualClock())
    assert rep.requests == [] and rep.unfinished == 0


def test_daemon_streams_tokens_through_tickets(models):
    door = FrontDoor()
    seen = []
    tk = door.submit(ServeRequest(0, "a", 0.0, 8, 3, 1.0), at=0.0,
                     on_token=lambda tok, t: seen.append((tok, t)))
    door.close(at=0.01)
    sink = []
    eng = _port(models)
    rep = eng.serve_forever(door, clock=VirtualClock())
    (req,) = rep.requests
    assert tk.done and not tk.shed
    assert tk.tokens == req.tokens_out and len(tk.tokens) == 3
    assert [tok for tok, _ in seen] == req.tokens_out
    assert all(a <= b for (_, a), (_, b) in zip(seen, seen[1:]))
    assert seen[-1][1] == req.finish_t
    # an engine-level token_sink sees the same stream (and the daemon
    # leaves it in place)
    eng = _port(models, token_sink=lambda r, tok, t: sink.append((tok, t)))
    door = FrontDoor()
    door.submit(ServeRequest(0, "a", 0.0, 8, 3, 1.0), at=0.0)
    door.close(at=0.01)
    eng.serve_forever(door, clock=VirtualClock())
    assert sink == seen and eng.token_sink is not None


@pytest.mark.parametrize("n_dev,admission", [(1, False), (2, True)])
def test_virtual_clock_daemon_bitwise_equals_replay(models, n_dev,
                                                    admission):
    """A preloaded door on the follower VirtualClock reduces exactly to
    ``run`` on the same trace (same tokens, same finish times, bitwise).
    On one device the JAX package's daemon gives the same; on two it
    gives every device the fleet's next arrival, and device 0 waits for
    device 1's requests (its finish times move by the arrival gap), so
    there only its tokens are compared."""
    trace = _trace(n=6, rate=1e4, max_new=2)
    kw = dict(num_devices=n_dev, admission_control=admission, certify=True)
    rep_replay = _port(models, **kw).run(trace)

    def door_of(mk):
        door = FrontDoor()
        for r in trace:
            door.submit(mk(r.req_id, r.tenant, r.arrival_t, r.prompt_len,
                           r.max_new_tokens, r.slo_s), at=r.arrival_t)
        door.close(at=max(r.arrival_t for r in trace))
        return door

    rep = _port(models, **kw).serve_forever(door_of(ServeRequest),
                                            clock=VirtualClock())
    assert _tokens(rep) == _tokens(rep_replay)
    fin = {r.req_id: r.finish_t for r in rep_replay.requests}
    assert all(r.finish_t == fin[r.req_id] for r in rep.requests)
    assert rep.jit.hazard_violations == 0 and rep.num_devices == n_dev
    from repro.serving import FrontDoor as JaxDoor, VirtualClock as JaxClock
    from repro.serving import ServeRequest as JaxRequest
    jdoor = JaxDoor()
    for r in trace:
        jdoor.submit(JaxRequest(r.req_id, r.tenant, r.arrival_t,
                                r.prompt_len, r.max_new_tokens, r.slo_s),
                     at=r.arrival_t)
    jdoor.close(at=max(r.arrival_t for r in trace))
    jrep = _ref(models, **kw).serve_forever(jdoor, clock=JaxClock())
    assert _tokens(rep) == _tokens(jrep)
    if n_dev == 1:
        assert [r.finish_t for r in rep.requests] == pytest.approx(
            [r.finish_t for r in jrep.requests], rel=REL)


def test_daemon_real_clock_live_submissions(models):
    """MonotonicClock: a feeder thread submits three live requests and
    closes the door while the daemon runs; everything flushes and each
    token's time is on the real clock."""
    eng = _port(models)
    door = FrontDoor()
    seen = {}

    def feeder():
        for i in range(3):
            door.submit(ServeRequest(i, "ab"[i % 2], 0.0, 8, 2, 10.0),
                        on_token=lambda tok, t, i=i:
                        seen.setdefault(i, []).append(t))
        door.close()

    th = threading.Thread(target=feeder)
    th.start()
    rep = eng.serve_forever(door, clock=MonotonicClock())
    th.join(timeout=30)
    assert not th.is_alive()
    assert len(rep.requests) == 3 and rep.unfinished == 0
    assert all(r.arrival_t >= 0.0 and r.finish_t >= r.arrival_t
               for r in rep.requests)
    assert {i: len(ts) for i, ts in seen.items()} == {0: 2, 1: 2, 2: 2}
    assert rep.wall_time_s < 30.0
