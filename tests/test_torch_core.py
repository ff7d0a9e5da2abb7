"""The port's copied scheduling core against the JAX package's, on the CPU.

The cost model, clustering, autotuner, coalescer and OoO scheduler were
copied over unchanged apart from their imports (and the H100 ``Device``
beside V100 and TPU-v5e). Fed the same op streams, both packages must make
the same decisions: same dispatch/wait sequence, same groups, same block
choices, same modelled times — exactly, since the arithmetic is the same
Python. tests/test_core.py is the template.
"""
import math

import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import autotuner as j_at
from repro.core import clustering as j_cl
from repro.core import coalescer as j_co
from repro.core import costmodel as j_cm
from repro.core import kernelspec as j_ks
from repro.core import scheduler as j_sc
from repro_torch.configs import get_config
from repro_torch.core import autotuner as t_at
from repro_torch.core import clustering as t_cl
from repro_torch.core import coalescer as t_co
from repro_torch.core import costmodel as t_cm
from repro_torch.core import kernelspec as t_ks
from repro_torch.core import scheduler as t_sc

DEVICES = ("V100", "TPUV5E")
ARCHS = ("yi-9b", "gemma3-1b", "granite-34b", "stablelm-12b")


def _shapes(seed=0, n=40):
    rng = np.random.default_rng(seed)
    dims = [128, 256, 512, 1152, 2048, 4096, 11008, 16384]
    return [(int(rng.choice([1, 4, 8, 16, 64, 256])), int(rng.choice(dims)),
             int(rng.choice(dims)), int(rng.choice([2, 4])))
            for _ in range(n)]


@pytest.mark.parametrize("dev", DEVICES)
def test_cost_model_times_match(dev):
    jc = j_cm.CostModel(getattr(j_cm, dev))
    tc = t_cm.CostModel(getattr(t_cm, dev))
    shapes = _shapes()
    js = [j_cm.GemmShape(m, n, k, b) for m, n, k, b in shapes]
    ts = [t_cm.GemmShape(m, n, k, b) for m, n, k, b in shapes]
    for a, b in zip(js, ts):
        assert tc.gemm_time(b) == jc.gemm_time(a)
    for g in (2, 3, 8):
        assert tc.coalesced_time(ts[:g]) == jc.coalesced_time(js[:g])
        assert tc.time_multiplexed(ts[:g]) == jc.time_multiplexed(js[:g])
        assert tc.coalesced_time(ts[:g], shared_operand=True) == \
            jc.coalesced_time(js[:g], shared_operand=True)


def test_h100_device_is_spec_sheet():
    h = t_cm.H100
    assert (h.num_units, h.hbm_bw, h.peak_flops) == (132, 3.35e12, 989e12)
    assert h.vmem_bytes == 227 * 1024 and h.l2_bytes == 50 * 1024 * 1024
    assert t_cm.V100 == t_cm.Device(**{
        f: getattr(j_cm.V100, f) for f in j_cm.V100.__dataclass_fields__})


@pytest.mark.parametrize("dev", DEVICES)
def test_autotuner_choices_match(dev):
    ja = j_at.Autotuner(j_cm.CostModel(getattr(j_cm, dev)))
    ta = t_at.Autotuner(t_cm.CostModel(getattr(t_cm, dev)))
    for m, n, k, b in _shapes(seed=1, n=12):
        js, ts = j_cm.GemmShape(m, n, k, b), t_cm.GemmShape(m, n, k, b)
        assert ta.tune_greedy(ts).__dict__ == ja.tune_greedy(js).__dict__
        assert ta.tune_collaborative(ts, 4).__dict__ == \
            ja.tune_collaborative(js, 4).__dict__


def test_clustering_and_population_match():
    jrows = j_ks.zoo_population([jax_get_config(a) for a in ARCHS], batch=4)
    trows = t_ks.zoo_population([get_config(a) for a in ARCHS], batch=4)
    assert [(a, t, s.__dict__) for a, t, s in trows] == \
        [(a, t, s.__dict__) for a, t, s in jrows]
    jcl = j_cl.cluster_greedy([s for _, _, s in jrows])
    tcl = t_cl.cluster_greedy([s for _, _, s in trows])
    assert [(c.pad_n, c.pad_k, len(c.members), c.padding_waste)
            for c in tcl] == \
        [(c.pad_n, c.pad_k, len(c.members), c.padding_waste) for c in jcl]


def _run_streams(ks, cm, co, sc, dev, arrivals):
    """Drive one scheduler over staged op streams the way the JIT does:
    a stream's next op is pushed only after its previous one dispatched;
    stream s arrives at ``arrivals[s]``. Returns the decision log."""
    cost = cm.CostModel(getattr(cm, dev))
    sched = sc.OoOScheduler(cost, co.Coalescer(cost, max_group=8))
    progs = []
    for s, (arch, t0, slo) in enumerate(arrivals):
        cfg = get_config(arch) if ks is t_ks else jax_get_config(arch)
        cfg = type(cfg)(**{**cfg.__dict__, "num_layers": 2})
        ops = ks.stream_program(cfg, s, batch=4, arrival_t=t0, slo_s=slo)
        sched.annotate_stream(ops)
        progs.append([t0, ops, 0])
    log, now = [], 0.0
    while True:
        due = [p for p in progs if p[0] <= now and p[2] == 0 and p[1]]
        for p in due:
            sched.push([p[1][0]])
            p[2] = 1
        future = [p[0] for p in progs if p[0] > now]
        sched.next_arrival_t = min(future) if future else math.inf
        d = sched.decide(now)
        if d.kind == "idle":
            if not future:
                break
            now = min(future)
            continue
        if d.kind == "wait":
            log.append(("wait", d.wait_until))
            now = d.wait_until
            continue
        ids = tuple((o.stream_id, o.seq_index, o.tag) for o in d.plan.ops)
        log.append(("dispatch", ids, d.plan.block.__dict__,
                    d.plan.est_time_s, d.plan.padding_waste))
        now += d.plan.est_time_s
        for o in d.plan.ops:
            p = progs[o.stream_id]
            p[1].pop(0)
            if p[1]:
                sched.push([p[1][0]])
    return log, sched.evictions


@pytest.mark.parametrize("dev", DEVICES)
def test_scheduler_decisions_match(dev):
    arrivals = [("yi-9b", 0.0, 0.05), ("yi-9b", 0.0, 0.02),
                ("gemma3-1b", 2e-5, 1e-3), ("yi-9b", 4e-5, 1e-6),
                ("granite-34b", 1e-4, 0.1)]
    jlog, jev = _run_streams(j_ks, j_cm, j_co, j_sc, dev, arrivals)
    tlog, tev = _run_streams(t_ks, t_cm, t_co, t_sc, dev, arrivals)
    assert len(tlog) > 20
    assert any(e[0] == "wait" for e in tlog)          # the stagger branch ran
    assert any(len(e[1]) > 1 for e in tlog if e[0] == "dispatch")
    assert tlog == jlog and tev == jev
