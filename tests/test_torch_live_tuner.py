"""Live collaborative autotuning in the port's engine, on the CPU, against
the JAX package's (the engine half of tests/test_live_tuner.py).

Four gemma3-1b smoke tenants on one fp32 weight set (made by the JAX
package, carried across with ``params_from_numpy``), the JAX engine's
prompts through ``prompt_fn`` and the same modelled device (``TPUV5E``,
each package's own copy) on both sides:

  * per objective (collaborative, greedy): the tune cache holds the JAX
    engine's keys, each with the JAX engine's tuned ``BlockConfig``;
    tokens equal the JAX engine's and the port's own untuned run; one
    search per signature (misses == the tuner's results) and hits after;
    ``ServeReport.jit.tune_cache`` carries the run's delta;
  * a weight hot-swap re-tunes nothing (tuning keys are shapes only);
  * a 2-device mesh keys both devices, and the report counts the shared
    tune cache's delta once;
  * a spy on ``coalesced_gemm`` sees the tuned ``bm`` at the launch, in
    the stacked and the per-layer regime, and ``bm = 8`` without tuning.
"""
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
from repro_torch.core import dispatch as tdispatch
from repro_torch.core import jit as tjit
from repro_torch.core.costmodel import CostModel, TPUV5E
from repro_torch.models import Model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import ServingEngine, Tenant
from repro_torch.serving.workload import two_wave_trace

NAMES = ["a", "b", "c", "d"]
OBJECTIVES = ["collaborative", "greedy"]


@pytest.fixture(scope="module")
def gemma():
    jm = JaxModel(jax_smoke_config("gemma3-1b"), param_dtype=jnp.float32)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(smoke_config("gemma3-1b"), param_dtype=torch.float32,
               device="cpu")
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jm, jp, tm, tp


def _jax_prompt(cfg, req, rng=jax.random.PRNGKey(0)):
    return np.array(jax.random.randint(jax.random.fold_in(rng, req.req_id),
                                       (1, req.prompt_len), 0,
                                       cfg.vocab_size))


def _trace(names, steps=6, prompt_len=8):
    return two_wave_trace(list(names), [], 1e-5, prompt_len=prompt_len,
                          max_new_tokens=steps, slo_s=10.0)


def _port(gemma, names, params=None, **kw):
    _, _, m, p = gemma
    return ServingEngine(
        [Tenant(n, m, params if params is not None else p, cache_len=64,
                max_batch=2) for n in names],
        mode="vliw", cost=CostModel(TPUV5E), device="cpu",
        prompt_fn=lambda t, r: torch.from_numpy(_jax_prompt(t.cfg, r)), **kw)


def _ref(gemma, names, **kw):
    m, p = gemma[:2]
    return JaxEngine([JaxTenant(n, m, p, cache_len=64, max_batch=2)
                      for n in names], mode="vliw", cost=JaxCostModel(JTPU),
                     **kw)


def _tokens(rep):
    return [r.tokens_out for r in sorted(rep.requests,
                                         key=lambda r: r.req_id)]


def _blocks(cache):
    """{key: (bm, bn, bk)} of a tune cache (either package's)."""
    out = {}
    for k in cache.keys():
        b = cache.peek(k).block
        out[k] = (b.bm, b.bn, b.bk)
    return out


@pytest.fixture(scope="module")
def untuned(gemma):
    return _port(gemma, NAMES).run(_trace(NAMES))


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_tuned_blocks_and_tokens_equal_reference(gemma, untuned, objective):
    jeng = _ref(gemma, NAMES, live_tune=True, tune_objective=objective)
    jrep = jeng.run(_trace(NAMES))
    eng = _port(gemma, NAMES, live_tune=True, tune_objective=objective)
    rep = eng.run(_trace(NAMES))
    # live tuning retiles dispatches but changes no token
    assert _tokens(rep) == _tokens(jrep) == _tokens(untuned)
    # the same signatures tuned to the same tiles
    assert _blocks(eng.jit.tune_cache) == _blocks(jeng.jit.tune_cache)
    assert {k[2] for k in eng.jit.tune_cache.keys()} == {objective}
    st = eng.jit.tune_cache.stats
    # steady state: one search per distinct signature, hits after
    assert st.misses == len(eng.jit.tuner.results) > 0
    assert st.hits > st.misses
    assert st.invalidations == 0
    assert (st.hits, st.misses) == (jeng.jit.tune_cache.stats.hits,
                                    jeng.jit.tune_cache.stats.misses)
    # the report carries the run's delta
    assert rep.jit.tune_cache.accesses == st.accesses
    # packed weights depend on (K, N) only: the tuned tiles repack nothing
    assert rep.jit.dispatch.weight_misses == \
        untuned.jit.dispatch.weight_misses
    # the same event loop: the same decisions
    assert rep.jit.superkernels == jrep.jit.superkernels
    assert rep.modeled_time_s == pytest.approx(jrep.modeled_time_s)


def test_untuned_run_leaves_the_tune_cache_empty(untuned):
    assert untuned.jit.tune_cache.accesses == 0


def test_hot_swap_leaves_tuned_configs_intact(gemma):
    """Tuning keys are shapes only: a weight hot-swap repacks weights but
    evicts and re-tunes no config."""
    eng = _port(gemma, ["a", "b"], live_tune=True)
    eng.run(_trace(["a", "b"]))
    pc = eng.jit.tune_cache
    before = _blocks(pc)
    assert before
    misses0 = pc.stats.misses
    _, _, m, _ = gemma
    eng.tenants["a"].params = m.init(torch.Generator().manual_seed(7))
    rep = eng.run(_trace(["a", "b"]))
    assert rep.jit.dispatch.weight_misses > 0      # the swap repacked
    assert pc.stats.invalidations == 0
    assert pc.stats.misses == misses0          # zero re-tunes
    assert _blocks(pc) == before


def test_mesh_tuning_is_device_keyed_and_counted_once(gemma):
    eng = _port(gemma, NAMES, live_tune=True, num_devices=2)
    rep = eng.run(_trace(NAMES, steps=4))
    keys = eng.jit.tune_cache.keys()
    assert keys and all(k[0] == "tune" for k in keys)
    # both devices tuned their own groups under their own key space
    assert {k[1] for k in keys} == {0, 1}
    # the sessions share one tune cache: the report holds its delta once
    st = eng.jit.tune_cache.stats
    assert rep.jit.tune_cache.accesses == st.accesses > 0
    assert rep.jit.tune_cache.misses == st.misses
    jeng = _ref(gemma, NAMES, live_tune=True, num_devices=2)
    jeng.run(_trace(NAMES, steps=4))
    assert _blocks(eng.jit.tune_cache) == _blocks(jeng.jit.tune_cache)


@pytest.mark.parametrize("stacked", [True, False])
def test_tuned_bm_reaches_the_launch(gemma, monkeypatch, stacked):
    """Every launch of a tuned run takes a tuned ``bm`` (stacked bodies
    through ``_scan_gemm``, plain groups through the executor); an untuned
    run launches at ``bm = 8``. Prompts of 16 tokens take declared
    prefill, whose groups tune to other tiles than decode's."""
    launched = []
    inner = tdispatch.coalesced_gemm

    def spy(a, b, gids, *, bm=8):
        launched.append(bm)
        return inner(a, b, gids, bm=bm)

    monkeypatch.setattr(tdispatch, "coalesced_gemm", spy)
    monkeypatch.setattr(tjit, "coalesced_gemm", spy)
    trace = _trace(NAMES, steps=4, prompt_len=16)
    base = _port(gemma, NAMES, stacked_layers=stacked).run(trace)
    assert launched and set(launched) == {8}
    launched.clear()
    eng = _port(gemma, NAMES, live_tune=True, stacked_layers=stacked)
    rep = eng.run(trace)
    tuned = {r.block.bm for r in eng.jit.tuner.results.values()}
    assert launched and set(launched) <= tuned
    assert set(launched) - {8}, "the tuner chose the default tile only"
    assert _tokens(rep) == _tokens(base)
