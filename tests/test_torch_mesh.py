"""The port's modelled multi-device mesh against the JAX package's, on the
CPU: placement, per-device accounting, tokens across mesh sizes, the
certifier's placement hazards and the device-keyed caches.

The fleet of tests/test_multi_device.py: 8 tenants (4 gemma3-1b, 2 grok-1
and 2 mamba2-2.7b smoke, fp32, the JAX package's weights carried across
with ``params_from_numpy``, its prompts through ``prompt_fn``), 2 requests
each, served in ``vliw`` mode with ``certify=True`` on 1, 2 and 4 modelled
devices by both engines on the same cost model (``TPUV5E``; the port's
copy of the JAX package's ``Device``). Tolerances: tokens, placement and
per-device dispatch counts exact; per-device modelled times within 1e-9
relative (the same float sums in the same order; only the last ulp may
move).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core.costmodel import CostModel as JaxCostModel, TPUV5E as JTPU
from repro.models import Model as JaxModel
from repro.serving import ServingEngine as JaxEngine, Tenant as JaxTenant
from repro_torch.analysis import certify_trace, check_conservation
from repro_torch.configs import smoke_config
from repro_torch.core import GemmShape, make_op
from repro_torch.core.coalescer import Coalescer
from repro_torch.core.costmodel import H100, TPUV5E, V100, CostModel
from repro_torch.core.dispatch import SuperkernelExecutor
from repro_torch.core.plancache import PlanCache
from repro_torch.core.schedtrace import PlacementHazard
from repro_torch.distributed import DeviceSet, PlacementPolicy
from repro_torch.models import Model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import ServingEngine, Tenant, make_trace

ARCHES = ["gemma3-1b", "grok-1-314b", "mamba2-2.7b"]
FLEET = ["gemma3-1b"] * 4 + ["grok-1-314b"] * 2 + ["mamba2-2.7b"] * 2
NAMES = [f"t{i}" for i in range(len(FLEET))]
REL = 1e-9


@pytest.fixture(scope="module")
def models():
    out = {}
    for i, arch in enumerate(ARCHES):
        jm = JaxModel(jax_smoke_config(arch), param_dtype=jnp.float32)
        jp = jm.init(jax.random.PRNGKey(i + 1))
        tm = Model(smoke_config(arch), param_dtype=torch.float32,
                   device="cpu")
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")
        out[arch] = (jm, jp, tm, tp)
    return out


def _jax_prompt(cfg, req, rng=jax.random.PRNGKey(0)):
    return np.array(jax.random.randint(jax.random.fold_in(rng, req.req_id),
                                       (1, req.prompt_len), 0,
                                       cfg.vocab_size))


def _trace(max_new=3, rate=1e4):
    return make_trace(NAMES, rate_hz=rate, n_per_tenant=2, prompt_len=6,
                      max_new_tokens=max_new, slo_s=1.0)


def _port(models, n, **kw):
    tenants = [Tenant(name, *models[arch][2:], cache_len=32, max_batch=2)
               for name, arch in zip(NAMES, FLEET)]
    return ServingEngine(
        tenants, mode="vliw", num_devices=n, cost=CostModel(TPUV5E),
        device="cpu",
        prompt_fn=lambda t, r: torch.from_numpy(_jax_prompt(t.cfg, r)), **kw)


def _ref(models, n, **kw):
    tenants = [JaxTenant(name, *models[arch][:2], cache_len=32, max_batch=2)
               for name, arch in zip(NAMES, FLEET)]
    return JaxEngine(tenants, mode="vliw", num_devices=n,
                     cost=JaxCostModel(JTPU), **kw)


def _tokens(rep):
    return {r.req_id: tuple(r.tokens_out or ()) for r in rep.requests}


@pytest.fixture(scope="module")
def runs(models):
    """Both engines, certified, at mesh sizes 1, 2 and 4:
    {n: ((ref engine, report), (port engine, report))}."""
    out = {}
    for n in (1, 2, 4):
        jeng, teng = _ref(models, n, certify=True), \
            _port(models, n, certify=True)
        out[n] = ((jeng, jeng.run(_trace())), (teng, teng.run(_trace())))
    return out


@pytest.mark.parametrize("n", [1, 2, 4])
def test_tokens_identical_across_mesh_sizes_and_to_reference(runs, n):
    (_, jrep), (_, trep) = runs[n]
    assert trep.unfinished == 0
    assert all(len(t) == 3 for t in _tokens(trep).values())
    assert _tokens(trep) == _tokens(jrep)
    assert _tokens(trep) == _tokens(runs[1][1][1])
    assert trep.jit.hazard_checks == jrep.jit.hazard_checks > 0
    assert trep.jit.hazard_violations == 0


@pytest.mark.parametrize("n", [1, 2, 4])
def test_placement_and_skew_equal_reference(runs, n):
    (jeng, jrep), (teng, trep) = runs[n]
    assert {k: (p.device, p.expert_span)
            for k, p in teng.placement.assignments.items()} == \
        {k: (p.device, p.expert_span)
         for k, p in jeng.placement.assignments.items()}
    assert teng.placement.load == pytest.approx(jeng.placement.load, rel=REL)
    assert max(teng.placement.load) <= teng.placement.load_bound() + 1e-12
    assert trep.num_devices == n
    assert trep.device_skew == pytest.approx(jrep.device_skew, rel=REL)
    if n == 4:
        assert {p.device for p in teng.placement.assignments.values()} == \
            {0, 1, 2, 3}


@pytest.mark.parametrize("n", [1, 2, 4])
def test_device_times_equal_reference(runs, n):
    (jeng, jrep), (teng, trep) = runs[n]
    assert trep.device_time_s == pytest.approx(jrep.device_time_s, rel=REL)
    assert trep.device_busy_s == pytest.approx(jrep.device_busy_s, rel=REL)
    assert trep.device_util == pytest.approx(jrep.device_util, rel=REL)
    assert trep.modeled_time_s == pytest.approx(max(trep.device_time_s))
    assert trep.jit.collective_time_s == pytest.approx(
        jrep.jit.collective_time_s, rel=REL)
    # grok spans the mesh when its 4 experts divide it: the all-to-all is
    # charged, not free
    assert (trep.jit.collective_time_s > 0.0) == (n > 1)
    per_dev = [[len(d.ops) for d in tr.dispatches if d.device == dev]
               for tr in (teng.last_trace, jeng.last_trace)
               for dev in range(n)]
    assert per_dev[:n] == per_dev[n:]


@pytest.mark.parametrize("n", [1, 2, 4])
def test_shared_cache_counters_counted_once(runs, n):
    """The mesh's sessions share one executor and one pair of plan caches:
    the report holds their counters of the run once, not once a device."""
    (_, _), (teng, trep) = runs[n]
    assert trep.jit.dispatch == teng.jit.executor.stats
    assert trep.jit.plan_cache == teng.jit.plan_cache.stats
    assert trep.jit.block_plans == teng.jit.block_plans.stats
    assert trep.jit.dispatch.dispatches >= len(teng.last_trace.dispatches)


def test_groups_never_mix_devices(runs):
    (_, _), (teng, trep) = runs[4]
    trace = teng.last_trace
    assert {d.device for d in trace.dispatches} == {0, 1, 2, 3}
    for d in trace.dispatches:
        assert all(op.device == d.device for op in d.ops)
    for rid, dev in trace.retire_devices.items():
        assert trace.req_devices[rid] == dev
    assert trep.jit.coalesced_groups > 0


def test_mesh_not_slower_when_the_fleet_queues(models):
    """Near-simultaneous arrivals: four devices finish the modelled
    makespan sooner than one, as in the JAX package."""
    sat = _trace(max_new=8, rate=1e9)
    t1 = _port(models, 1).run(sat).modeled_time_s
    t4 = _port(models, 4).run(sat).modeled_time_s
    assert t4 < t1


def test_expert_span_requires_divisibility():
    cfg = smoke_config("grok-1-314b")       # 4 experts
    assert PlacementPolicy(DeviceSet.homogeneous(V100, 3)).expert_span(cfg) \
        == 1
    pol2 = PlacementPolicy(DeviceSet.homogeneous(V100, 2))
    assert pol2.expert_span(cfg) == 2
    assert pol2.expert_span(smoke_config("gemma3-1b")) == 1
    # the port's mesh defaults to its H100 profile, one cost model shared
    ds = DeviceSet.homogeneous(n=2)
    assert ds.devices == [H100, H100] and ds.cost(0) is ds.cost(1)


# ---------------------------------------------------------------------------
# the certifier's placement checks on a real 2-device trace
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mutation", ["device-mixed", "offsite",
                                      "cross-device-retire"])
def test_placement_mutations_raise(runs, mutation):
    (_, _), (teng, _) = runs[2]
    trace = copy.deepcopy(teng.last_trace)
    assert certify_trace(trace, raise_on_violation=False).violations == []
    if mutation == "cross-device-retire":
        rid = next(iter(trace.retire_devices))
        trace.retire_devices[rid] = trace.req_devices[rid] + 1
        violations = check_conservation(trace, raise_on_violation=False)
    else:
        victim = next(d for d in trace.dispatches if d.ops)
        if mutation == "device-mixed":
            victim.ops[0].device = victim.device + 1
        else:
            victim.device += 1
        violations = certify_trace(trace, raise_on_violation=False).violations
    assert any(isinstance(v, PlacementHazard) for v in violations)


# ---------------------------------------------------------------------------
# the memo and weight caches are keyed by device
# ---------------------------------------------------------------------------

def test_block_plan_memo_is_device_keyed():
    memo = PlanCache(64)
    c_fast = Coalescer(CostModel(TPUV5E), memo=memo, device_id=0)
    c_slow = Coalescer(CostModel(V100), memo=memo, device_id=1)

    def ops_on(device):
        ops = []
        for i in range(2):
            op = make_op(i, "gemv", GemmShape(m=4, n=256, k=128))
            op.device = device
            ops.append(op)
        return ops

    t0 = c_fast.plan(ops_on(0)).est_time_s
    assert c_slow.plan(ops_on(1)).est_time_s != t0
    assert c_fast.plan(ops_on(0)).est_time_s == t0


@pytest.mark.parametrize("stacked_operand", [False, True])
def test_weight_cache_is_device_keyed(stacked_operand):
    """One executor (one weight cache) serves every device; each device
    stages its own pack, and the math is the same on each."""
    ex = SuperkernelExecutor(PlanCache(32), bm=8)
    g = torch.Generator().manual_seed(0)
    probs = [(torch.randn(4, 128, generator=g),
              torch.randn(128, 256, generator=g)) for _ in range(2)]
    w3 = torch.randn(3, 128, 256, generator=g)

    def call(device):
        if stacked_operand:
            return [ex.stacked_operand(("w3",), 128, 256, 3, lambda: w3,
                                       (w3,), device=device)]
        ops = []
        for i, (a, w) in enumerate(probs):
            op = make_op(i, "gemv", GemmShape(m=4, n=256, k=128))
            op.payload = (a, w, ("w", i))
            ops.append(op)
        return ex.execute(ops, device=device)

    out0 = call(0)
    misses0 = ex.stats.weight_misses
    call(0)
    assert ex.stats.weight_misses == misses0 and ex.stats.weight_hits > 0
    out1 = call(1)
    assert ex.stats.weight_misses > misses0
    for a, b in zip(out0, out1):
        assert torch.equal(a, b)
