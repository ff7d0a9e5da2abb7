"""The port's layer-stacked templates, on the CPU: the counterpart of
tests/test_stacked_templates.py for dense tenants.

The model is gemma3-1b smoke at 8 layers with gemma3's own period of one
global layer in six (``global_every=6``; the smoke config's 2 would make
every sub-stack one layer long). Its flags F F F F F T F F give three
sub-stacks of 5, 1 and 2 layers, so the body's loop, the partition and the
epilogue's concatenation are all exercised. Everything runs in fp32.

  * Bitwise (``torch.equal``): the port's stacked path against its own
    per-layer path, in logits and every cache leaf; decode over 3 steps at
    B = 1, 2, 4 and prefill at prompt lengths 5 and 12. Both paths run the
    same GEMMs (solo, same buckets, same envelopes) and the same glue.
  * Parity with the JAX package's stacked path (``stacked=True`` on both
    sides, weights carried across by ``models/convert.py``): logits and
    caches within 2e-4 (both compute in fp32, summing in other orders, as
    tests/test_torch_jit.py holds the per-layer templates), greedy tokens
    identical, and the same scheduling statistics under one cost model.
  * Structure, serving invariants and a 48-layer template and run.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core import jit as jjit
from repro.core.costmodel import CostModel as JaxCostModel, TPUV5E as JTPU
from repro.models import Model as JaxModel
from repro_torch.configs import smoke_config
from repro_torch.core import jit as tjit
from repro_torch.core.costmodel import CostModel, TPUV5E
from repro_torch.models import Model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import ServeRequest, ServingEngine, Tenant

TOL = dict(rtol=2e-4, atol=2e-4)
CL = 32


def _gemma8(cfg):
    return dataclasses.replace(cfg, num_layers=8, global_every=6)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model, port params), same weights."""
    jm = JaxModel(_gemma8(jax_smoke_config("gemma3-1b")),
                  param_dtype=jnp.float32)
    jp = jm.init(jax.random.PRNGKey(5))
    tm = Model(_gemma8(smoke_config("gemma3-1b")), param_dtype=torch.float32,
               device="cpu")
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jm, jp, tm, tp


def _inputs(V, B, S=12, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, (B, S)).astype(np.int32),
            rng.integers(0, V, (B, 1)).astype(np.int32))


def _port_decode(tm, tp, cache, tok, *, stacked, steps=3):
    """``steps`` greedy decode steps through one (re-bound) template."""
    tmpl = tjit.build_dense_decode_template(tm, tp, int(tok.shape[0]),
                                            stacked=stacked)
    vj = tjit.VLIWJit(CostModel(TPUV5E), max_group=8)
    logits, stats = [], []
    for _ in range(steps):
        prog = tmpl.bind(stream_id=0, tokens=tok, cache=cache)
        stats.append(vj.run([prog]))
        logits.append(prog.env["logits"])
        cache = prog.env["cache"]
        tok = torch.argmax(prog.env["logits"], dim=-1)[:, None]
    return logits, cache, stats


def _port_prefill(tm, tp, prompt_len, *, stacked, seed=4):
    toks = np.random.default_rng(seed).integers(
        0, tm.cfg.vocab_size, (1, prompt_len)).astype(np.int32)
    Sp = tjit.prefill_bucket(prompt_len)
    padded = np.pad(toks, ((0, 0), (0, Sp - prompt_len)))
    prog = tjit.build_dense_prefill_template(tm, tp, Sp, stacked=stacked) \
        .bind(stream_id=0, tokens=torch.from_numpy(padded).long(),
              cache=tm.init_cache(2, CL),
              env_extra={"real_len": prompt_len, "slot": 1})
    stats = tjit.VLIWJit(CostModel(TPUV5E), max_group=8).run([prog])
    return prog.env, stats, padded


def _assert_equal_envs(got_logits, got_cache, want_logits, want_cache):
    for s, (a, b) in enumerate(zip(got_logits, want_logits)):
        assert torch.equal(a, b), f"logits of step {s}"
    assert torch.equal(got_cache["pos"], want_cache["pos"])
    for leaf in want_cache["layers"]:
        assert torch.equal(got_cache["layers"][leaf],
                           want_cache["layers"][leaf]), leaf


# ---------------------------------------------------------------------------
# bitwise: stacked against the port's per-layer path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 2, 4])
def test_stacked_decode_bitwise_equal_to_per_layer(pair, batch):
    _, _, tm, tp = pair
    prompt, tok = _inputs(tm.cfg.vocab_size, batch)
    _, cache0 = tm.prefill(tp, {"tokens": torch.from_numpy(prompt).long()},
                           cache_len=CL)
    tok = torch.from_numpy(tok).long()
    want, want_cache, _ = _port_decode(tm, tp, cache0, tok, stacked=False)
    got, got_cache, _ = _port_decode(tm, tp, cache0, tok, stacked=True)
    _assert_equal_envs(got, got_cache, want, want_cache)


@pytest.mark.parametrize("prompt_len", [5, 12])
def test_stacked_prefill_bitwise_equal_to_per_layer(pair, prompt_len):
    _, _, tm, tp = pair
    got, _, _ = _port_prefill(tm, tp, prompt_len, stacked=True)
    want, _, _ = _port_prefill(tm, tp, prompt_len, stacked=False)
    _assert_equal_envs([got["logits"]], got["cache"], [want["logits"]],
                       want["cache"])


# ---------------------------------------------------------------------------
# parity with the JAX package's stacked path
# ---------------------------------------------------------------------------

def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _same_stats(ts, js):
    assert ts.superkernels == js.superkernels
    assert ts.ops_executed == js.ops_executed
    assert ts.shared_dispatches == js.shared_dispatches
    assert ts.mean_group == pytest.approx(js.mean_group)
    assert ts.modeled_time_s == pytest.approx(js.modeled_time_s)


def test_stacked_decode_matches_reference(pair):
    jm, jp, tm, tp = pair
    prompt, tok = _inputs(tm.cfg.vocab_size, 2)
    _, jcache = jm.prefill(jp, {"tokens": jnp.asarray(prompt)}, cache_len=CL)
    _, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(prompt).long()},
                           cache_len=CL)
    got, got_cache, tstats = _port_decode(tm, tp, tcache,
                                          torch.from_numpy(tok).long(),
                                          stacked=True)
    jtmpl = jjit.build_dense_decode_template(jm, jp, 2, stacked=True)
    jx = jjit.VLIWJit(JaxCostModel(JTPU), max_group=8)
    jtok = jnp.asarray(tok)
    for step, (logits, ts) in enumerate(zip(got, tstats)):
        prog = jtmpl.bind(stream_id=0, tokens=jtok, cache=jcache)
        js = jx.run([prog])
        _close(logits, prog.env["logits"])
        _same_stats(ts, js)
        jtok = jnp.argmax(prog.env["logits"], axis=-1).astype(
            jnp.int32)[:, None]
        # greedy tokens identical at every step
        np.testing.assert_array_equal(torch.argmax(logits, -1).numpy(),
                                      np.asarray(jtok[:, 0]), err_msg=step)
        jcache = prog.env["cache"]
    for leaf in ("k", "v"):
        _close(got_cache["layers"][leaf], jcache["layers"][leaf])
    np.testing.assert_array_equal(got_cache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))


@pytest.mark.parametrize("prompt_len", [5, 12])
def test_stacked_prefill_matches_reference(pair, prompt_len):
    jm, jp, tm, tp = pair
    got, ts, padded = _port_prefill(tm, tp, prompt_len, stacked=True)
    jprog = jjit.build_dense_prefill_template(
        jm, jp, int(padded.shape[1]), stacked=True).bind(
        stream_id=0, tokens=jnp.asarray(padded), cache=jm.init_cache(2, CL),
        env_extra={"real_len": prompt_len, "slot": 1})
    js = jjit.VLIWJit(JaxCostModel(JTPU), max_group=8).run([jprog])
    _close(got["logits"], jprog.env["logits"])
    assert int(torch.argmax(got["logits"])) == \
        int(jnp.argmax(jprog.env["logits"]))
    for leaf in ("k", "v"):
        _close(got["cache"]["layers"][leaf],
               jprog.env["cache"]["layers"][leaf])
    _same_stats(ts, js)


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [
    (), (False,), (True, True, True), (False, True),
    (False,) * 5 + (True,) + (False,) * 2,
    (True, False, False, True, True, False),
])
def test_partition_layers_matches_reference(flags):
    spans = tjit.partition_layers(flags)
    assert spans == jjit.partition_layers(flags)
    assert [i for lo, hi in spans for i in range(lo, hi)] == \
        list(range(len(flags)))


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_one_body_stage_per_substack(pair, kind):
    _, _, tm, tp = pair
    build = {"decode": tjit.build_dense_decode_template,
             "prefill": tjit.build_dense_prefill_template}[kind]
    spans = tjit.partition_layers(tm.cfg.global_layer_flags())
    assert spans == [(0, 5), (5, 6), (6, 8)]
    tmpl = build(tm, tp, 8)                      # stacked is the default
    bodies = [st for st in tmpl.stages
              if isinstance(st, tjit.StackedGemmStage)]
    assert [(b.tag, b.layers) for b in bodies] == \
        [(f"body_{lo}_{hi}", hi - lo) for lo, hi in spans]
    assert not any(isinstance(st, tjit.GemmStage) and st.tag != "unembed"
                   for st in tmpl.stages)
    # every operand is guarded on the ORIGINAL stacked params tensor
    attn = tp["blocks"]["attn"]
    assert all(b.operands[0].guard[0] is attn["wq"] for b in bodies)
    assert len(tmpl.stages) < len(build(tm, tp, 8, stacked=False).stages)


def test_depth_48_template_has_as_many_stages_as_depth_2():
    cfg2 = smoke_config("granite-34b")
    cfg48 = dataclasses.replace(cfg2, num_layers=48)
    assert tjit.partition_layers(cfg48.global_layer_flags()) == [(0, 48)]
    n = []
    for cfg in (cfg48, cfg2):
        m = Model(cfg, param_dtype=torch.float32, device="cpu")
        p = m.init(torch.Generator().manual_seed(8))
        n.append(len(tjit.build_dense_decode_template(m, p, 1).stages))
    assert n[0] == n[1]


def test_stacked_is_the_default_regime(pair):
    _, _, tm, tp = pair
    cache = tm.init_cache(2, CL)
    tok = torch.zeros((2, 1), dtype=torch.long)
    prog = tjit.build_dense_decode_program(tm, tp, tok, cache, stream_id=0)
    assert any(isinstance(st, tjit.StackedGemmStage) for st in prog.stages)
    assert tjit.dense_program_cache_key(tm, tp, 2, cache) == \
        tjit.dense_program_cache_key(tm, tp, 2, cache, stacked=True)
    assert tjit.prefill_program_cache_key(tm, tp, 8, cache) != \
        tjit.prefill_program_cache_key(tm, tp, 8, cache, stacked=False)
    eng = ServingEngine([Tenant("a", tm, tp, cache_len=CL)], device="cpu")
    assert eng.stacked_layers


def test_stacked_operand_is_one_entry_for_every_m(pair):
    """One padded [Lsub, K, N] entry per operand serves decode at every
    batch size and prefill at every bucket; the executor hands the kernel
    contiguous layers of it."""
    _, _, tm, tp = pair
    vj = tjit.VLIWJit(max_group=8)
    progs = [tjit.build_dense_decode_template(tm, tp, B).bind(
        stream_id=0, tokens=torch.zeros((B, 1), dtype=torch.long),
        cache=tm.init_cache(B, CL)) for B in (1, 4)]
    progs.append(tjit.build_dense_prefill_template(tm, tp, 16).bind(
        stream_id=0, tokens=torch.zeros((1, 16), dtype=torch.long),
        cache=tm.init_cache(4, CL), env_extra={"real_len": 16, "slot": 0}))
    misses = []
    for prog in progs:
        vj.run([prog])
        misses.append(vj.executor.stats.weight_misses)
    # the first run packs the 3 bodies' operands and the unembed (one miss
    # a dispatch); the runs at other m pack nothing
    stacks = [k for k in vj.weight_cache.keys() if k[0] == "wstack"]
    assert len(stacks) == 7 * 3                  # 7 operands, 3 sub-stacks
    assert misses == [3 + 1] * 3
    assert vj.executor.stats.weight_invalidations == 0
    for k in stacks:
        w = vj.weight_cache.peek(k)
        assert w.is_contiguous() and tuple(w.shape[1:]) == k[3:5]


# ---------------------------------------------------------------------------
# serving: engine-level token identity, hit rate, hot-swap, depth 48
# ---------------------------------------------------------------------------

def _tokens(rep):
    return {r.req_id: list(r.tokens_out) for r in rep.requests}


def _engine(tm, tp, **kw):
    return ServingEngine([Tenant("a", tm, tp, cache_len=CL, max_batch=2)],
                         device="cpu", **kw)


def test_engine_stacked_tokens_equal_per_layer(pair):
    _, _, tm, tp = pair
    trace = [ServeRequest(0, "a", 0.0, 8, 4, 1.0),
             ServeRequest(1, "a", 1e-4, 20, 4, 1.0)]
    reps = {s: _engine(tm, tp, stacked_layers=s).run(trace)
            for s in (True, False)}
    assert _tokens(reps[True]) == _tokens(reps[False])
    assert all(len(t) == 4 for t in _tokens(reps[True]).values())
    # one scheduler decision per body instead of one per layer GEMM
    assert reps[True].jit.superkernels < reps[False].jit.superkernels


def test_stacked_steady_state_hit_rate_and_guard(pair):
    """Plan-cache miss only on the first step, stable operands (no
    phantom hot-swap), and one hit or miss per dispatch."""
    _, _, tm, tp = pair
    steps = 5
    trace = [ServeRequest(0, "a", 0.0, 8, steps + 1, 1.0)]
    rep = _engine(tm, tp).run(trace)
    pc = rep.jit.plan_cache
    assert pc.misses == 1 and pc.hit_rate >= (steps - 1) / steps - 1e-9
    assert pc.invalidations == 0
    d = rep.jit.dispatch
    assert d.weight_invalidations == 0 and d.weight_hits > 0
    assert d.weight_hits + d.weight_misses == d.dispatches


def test_stacked_hot_swap_trips_guard(pair):
    """A real hot-swap (a new params tree) invalidates the stacked operands
    and converges to a fresh engine's tokens on the new weights."""
    _, _, tm, p_old = pair
    p_new = tm.init(torch.Generator().manual_seed(77))
    trace1 = [ServeRequest(0, "a", 0.0, 8, 3, 1.0)]
    trace2 = [ServeRequest(1, "a", 0.0, 8, 3, 1.0)]
    eng = _engine(tm, p_old)
    eng.run(trace1)
    assert eng.jit.plan_cache.stats.invalidations == 0
    inval0 = eng.jit.executor.stats.weight_invalidations
    eng.tenants["a"].params = p_new          # hot-swap, same model object
    rep_swapped = eng.run(trace2)
    assert eng.jit.plan_cache.stats.invalidations >= 1
    assert eng.jit.executor.stats.weight_invalidations > inval0
    assert _tokens(rep_swapped) == _tokens(_engine(tm, p_new).run(trace2))


def test_depth_48_serves_end_to_end():
    """granite-34b smoke at its real depth, 48 layers, serves through
    ``vliw`` with the ``batched`` mode's greedy tokens."""
    cfg = dataclasses.replace(smoke_config("granite-34b"), num_layers=48)
    m = Model(cfg, param_dtype=torch.float32, device="cpu")
    p = m.init(torch.Generator().manual_seed(8))
    trace = [ServeRequest(0, "a", 0.0, 6, 3, 1.0)]
    reps = {mode: _engine(m, p, mode=mode).run(trace)
            for mode in ("vliw", "batched")}
    toks = _tokens(reps["vliw"])
    assert toks == _tokens(reps["batched"])
    assert all(len(t) == 3 for t in toks.values())
