"""The port's serving engine against the JAX package's, on the CPU.

Two tenants (yi-9b and gemma3-1b smoke, weights carried across by
``models/convert.py``) serve one trace in ``vliw`` mode with declared
prefill (prompts of 16 and 20 tokens, at least ``prefill_declare_min``).
The port takes the JAX engine's own prompts through ``prompt_fn``. Each
request's greedy tokens must be identical to the JAX package's
``ServingEngine`` in the same regime (``stacked_layers`` False and True);
with the same cost model the two event loops also make the same scheduling
decisions. ``time`` and ``batched`` must give the port's ``vliw`` tokens
too.
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core.costmodel import CostModel as JaxCostModel, TPUV5E as JTPU
from repro.models import Model as JaxModel
from repro.serving import ServingEngine as JaxEngine, Tenant as JaxTenant
from repro_torch.configs import smoke_config
from repro_torch.core.costmodel import CostModel, TPUV5E
from repro_torch.models import Model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import ServeRequest, ServingEngine, Tenant

ARCHS = ("yi-9b", "gemma3-1b")
NAMES = ("t0:yi", "t1:gemma")


@pytest.fixture(scope="module")
def pair():
    """(JAX models+params, port models+params), same weights."""
    jax_side, port_side = [], []
    for i, arch in enumerate(ARCHS):
        jm = JaxModel(jax_smoke_config(arch), param_dtype=jnp.float32)
        jp = jm.init(jax.random.PRNGKey(i + 1))
        tm = Model(smoke_config(arch), param_dtype=torch.float32,
                   device="cpu")
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")
        jax_side.append((jm, jp))
        port_side.append((tm, tp))
    return jax_side, port_side


def _trace():
    reqs, rid = [], 0
    for k, name in enumerate(NAMES):
        for j in range(2):
            reqs.append(ServeRequest(rid, name, 1e-4 * (2 * j + k),
                                     prompt_len=16 + 4 * j, max_new_tokens=3,
                                     slo_s=0.05))
            rid += 1
    return sorted(reqs, key=lambda r: r.arrival_t)


def _jax_prompt(cfg, req, rng=jax.random.PRNGKey(0)):
    """The JAX engine's prompt for ``req`` (its ``_make_prompt``)."""
    return np.array(jax.random.randint(jax.random.fold_in(rng, req.req_id),
                                       (1, req.prompt_len), 0,
                                       cfg.vocab_size))


def _port_engine(port_side, mode, **kw):
    tenants = [Tenant(n, m, p, cache_len=32, max_batch=4)
               for n, (m, p) in zip(NAMES, port_side)]
    return ServingEngine(
        tenants, mode=mode, device="cpu",
        prompt_fn=lambda t, r: torch.from_numpy(_jax_prompt(t.cfg, r)),
        **kw)


def _tokens(report):
    return {r.req_id: list(r.tokens_out) for r in report.requests}


@pytest.mark.parametrize("stacked", [False, True])
def test_vliw_tokens_identical_to_reference(pair, stacked):
    jax_side, port_side = pair
    trace = _trace()
    jt = [JaxTenant(n, m, p, cache_len=32, max_batch=4)
          for n, (m, p) in zip(NAMES, jax_side)]
    jrep = JaxEngine(jt, mode="vliw", cost=JaxCostModel(JTPU),
                     stacked_layers=stacked).run(trace)
    trep = _port_engine(port_side, "vliw", cost=CostModel(TPUV5E),
                        stacked_layers=stacked).run(trace)
    want, got = _tokens(jrep), _tokens(trep)
    assert all(len(v) == 3 for v in want.values())
    assert got == want
    # the same event loop on the same cost model: same decisions
    assert trep.jit.superkernels == jrep.jit.superkernels
    assert trep.jit.shared_dispatches == jrep.jit.shared_dispatches
    assert trep.jit.mean_group == pytest.approx(jrep.jit.mean_group)
    assert trep.modeled_time_s == pytest.approx(jrep.modeled_time_s)
    assert [r.finish_t for r in trep.requests] == pytest.approx(
        [r.finish_t for r in jrep.requests])


def test_baseline_modes_give_vliw_tokens(pair):
    _, port_side = pair
    trace = _trace()
    reps = {mode: _port_engine(port_side, mode).run(trace)
            for mode in ("time", "batched", "vliw")}
    # the vliw engine's options change scheduling, never tokens: prompts
    # charged analytically instead of declared, arrivals predicted by the
    # EWMA instead of read from the trace
    reps["analytic"] = _port_engine(port_side, "vliw",
                                    declared_prefill=False).run(trace)
    reps["predicted"] = _port_engine(port_side, "vliw",
                                     predict_arrivals=True).run(trace)
    want = _tokens(reps["vliw"])
    for mode in ("time", "batched", "analytic", "predicted"):
        assert _tokens(reps[mode]) == want, mode
    assert reps["analytic"].jit.prefill_coalesced == 0
    j = reps["vliw"].jit
    assert j.superkernels > 0 and j.dispatch.retraces == 0
    assert reps["vliw"].unfinished == 0


def test_shared_weight_tenants_share_dispatches(pair):
    """Two tenants serving ONE params tree coalesce with operand sharing
    (prefill and decode templates hand out the same weight objects), and
    give the tokens the time-multiplexed baseline gives."""
    _, port_side = pair
    m, p = port_side[0]
    trace = [ServeRequest(i, NAMES[i % 2], 0.0, 16, 3, 0.05)
             for i in range(4)]

    def engine(mode):
        tenants = [Tenant(n, m, p, cache_len=32, max_batch=4)
                   for n in NAMES]
        return ServingEngine(tenants, mode=mode, device="cpu")

    v = engine("vliw").run(trace, seed=3)
    t = engine("time").run(trace, seed=3)
    assert _tokens(v) == _tokens(t)
    assert v.jit.shared_dispatches > 0 and v.jit.mean_group > 1.0
    assert v.jit.dispatch.weight_invalidations == 0


def test_unported_options_raise(pair):
    """Every keyword of the JAX package's engine is accepted; a value
    other than its default for an option not ported yet (live tuning)
    raises ``NotImplementedError`` naming the ROADMAP item, never
    ``TypeError``. The mesh, the certifier and the front door (items 9,
    10, 11) are ported: tests/test_torch_mesh.py, test_torch_analysis.py
    and test_torch_frontdoor.py hold them to the JAX package."""
    _, port_side = pair
    for kw, item in ((dict(live_tune=True), "item 14"),
                     (dict(tune_objective="greedy"), "item 14")):
        with pytest.raises(NotImplementedError, match=item):
            _port_engine(port_side, "vliw", **kw)
    # hybrid, vlm and audio tenants, and the int8 KV cache, are item 12:
    # their models refuse to be made, so no engine can hold them
    for arch in ("hymba-1.5b", "internvl2-2b", "whisper-tiny"):
        with pytest.raises(NotImplementedError, match="item 12"):
            Model(smoke_config(arch), param_dtype=torch.float32,
                  device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        Model(smoke_config("gemma3-1b"), param_dtype=torch.float32,
              device="cpu", kv_quant=True)


def test_engine_defaults_equal_reference():
    """Every keyword the two engines share has the same default, so the
    same call serves the same regime (``stacked_layers=True``)."""
    want = inspect.signature(JaxEngine.__init__).parameters
    got = inspect.signature(ServingEngine.__init__).parameters
    shared = [k for k in want if k not in ("self", "tenants", "cost",
                                           "sched_cfg")]
    assert set(shared) <= set(got), set(shared) - set(got)
    for k in shared:
        assert got[k].default == want[k].default, k
    assert got["stacked_layers"].default is True
    # the two packages' SchedulerConfig classes are copies: equal by value
    assert dataclasses.asdict(got["sched_cfg"].default) == \
        dataclasses.asdict(want["sched_cfg"].default)
