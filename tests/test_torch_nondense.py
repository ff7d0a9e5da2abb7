"""MoE and SSM tenants in the port, on the CPU: ``Model``, the decode
templates of both regimes and the serving engine, against the JAX package.

Families: grok-1 smoke with E = 2 and 4 experts (top-2, as
tests/test_nondense_programs.py sizes it) and mamba2-2.7b smoke, fp32,
weights made by the JAX package and carried across with
``params_from_numpy``; tokens from numpy with a seed.

  * ``Model``: the init tree has the JAX package's keys, shapes and dtypes;
    prefill and decode logits and caches within 2e-4.
  * Templates: the per-layer and the stacked template of each family equal
    the port's ``Model.decode_step`` within 2e-4 (the executor pads and
    sums through the kernel's plain version), with identical greedy
    tokens; stacked is BITWISE equal to per-layer (logits and every cache
    leaf, 3 steps). Against the JAX package's per-layer template
    (``stacked=False``, its bitwise oracle) within 2e-4: its stacked MoE /
    SSM path at batch 1 is not bitwise equal to its own oracle (a known
    reference fault), so the port is held to the oracle.
  * Structure: one body stage per sub-stack, expert packs of Lsub·E
    matrices, cache keys.
  * Serving: steady-state hit rates, a hot-swap that trips the guards,
    cross-tenant expert coalescing with the JAX engine's counters on the
    same trace, and a dense + MoE + SSM fleet token-identical across the
    three modes, both regimes and the JAX engine.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import MoEConfig as JaxMoEConfig
from repro.configs import smoke_config as jax_smoke_config
from repro.core import jit as jjit
from repro.core.costmodel import CostModel as JaxCostModel, TPUV5E as JTPU
from repro.models import Model as JaxModel
from repro.serving import ServingEngine as JaxEngine, Tenant as JaxTenant
from repro_torch.configs import MoEConfig, smoke_config
from repro_torch.core import jit as tjit
from repro_torch.core.costmodel import CostModel, TPUV5E
from repro_torch.models import Model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import ServeRequest, ServingEngine, Tenant

TOL = dict(rtol=2e-4, atol=2e-4)
CL = 32
FAMILIES = ("moe-e2", "moe-e4", "ssm")


def _cfgs(family):
    """(JAX config, port config) of a family."""
    if family == "ssm":
        return (jax_smoke_config("mamba2-2.7b"), smoke_config("mamba2-2.7b"))
    E = int(family[-1])
    jc, tc = jax_smoke_config("grok-1-314b"), smoke_config("grok-1-314b")
    return (dataclasses.replace(jc, name=f"{jc.name}-e{E}",
                                moe=JaxMoEConfig(num_experts=E, top_k=2)),
            dataclasses.replace(tc, name=f"{tc.name}-e{E}",
                                moe=MoEConfig(num_experts=E, top_k=2)))


def _make(family, seed=1):
    jcfg, tcfg = _cfgs(family)
    jm = JaxModel(jcfg, param_dtype=jnp.float32)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = Model(tcfg, param_dtype=torch.float32, device="cpu")
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def models():
    return {f: _make(f) for f in FAMILIES}


def _builders(family):
    if family == "ssm":
        return jjit.build_ssm_decode_template, tjit.build_ssm_decode_template
    return jjit.build_moe_decode_template, tjit.build_moe_decode_template


def _inputs(V, B, S=12, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, (B, S)).astype(np.int32),
            rng.integers(0, V, (B, 1)).astype(np.int32))


def _prefilled(tm, tp, B, seed=3):
    prompt, tok = _inputs(tm.cfg.vocab_size, B, seed=seed)
    _, cache = tm.prefill(tp, {"tokens": torch.from_numpy(prompt).long()},
                          cache_len=CL)
    return cache, torch.from_numpy(tok).long()


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}/"))
        else:
            out[pre + k] = v
    return out


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["grok-1-314b", "mamba2-2.7b"])
def test_model_init_tree_matches_reference(arch):
    jm = JaxModel(jax_smoke_config(arch), param_dtype=jnp.bfloat16)
    want = _flat(jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    tm = Model(smoke_config(arch), param_dtype=torch.bfloat16, device="cpu")
    got = _flat(tm.init(torch.Generator().manual_seed(0)))
    assert sorted(got) == sorted(want)
    for k, spec in want.items():
        assert tuple(got[k].shape) == tuple(spec.shape), k
        assert str(got[k].dtype).removeprefix("torch.") == \
            jnp.dtype(spec.dtype).name, k


@pytest.mark.parametrize("family", FAMILIES)
def test_model_prefill_decode_match_reference(models, family):
    jm, jp, tm, tp = models[family]
    prompt, tok = _inputs(tm.cfg.vocab_size, 2)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(prompt)}, cache_len=CL)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(prompt).long()},
                        cache_len=CL)
    _close(tl, jl)
    assert sorted(tc["layers"]) == sorted(jc["layers"])
    for step in range(3):
        jl, jc = jm.decode_step(jp, jnp.asarray(tok), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok).long(), tc)
        _close(tl, jl)
        for k in jc["layers"]:
            _close(tc["layers"][k], jc["layers"][k])
            assert tc["layers"][k].dtype == tm.init_cache(2, CL)[
                "layers"][k].dtype
        tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        np.testing.assert_array_equal(tl[:, -1].argmax(-1).numpy(),
                                      tok[:, 0], err_msg=str(step))


# ---------------------------------------------------------------------------
# templates
# ---------------------------------------------------------------------------

def _port_decode(tm, tp, cache, tok, *, stacked, steps=3):
    """``steps`` greedy decode steps through one (re-bound) template."""
    build = _builders("ssm" if tm.cfg.arch_type == "ssm" else "moe")[1]
    tmpl = build(tm, tp, int(tok.shape[0]), stacked=stacked)
    vj = tjit.VLIWJit(CostModel(TPUV5E), max_group=8)
    logits = []
    for _ in range(steps):
        prog = tmpl.bind(stream_id=0, tokens=tok, cache=cache)
        vj.run([prog])
        logits.append(prog.env["logits"])
        cache = prog.env["cache"]
        tok = torch.argmax(prog.env["logits"], dim=-1)[:, None]
    return logits, cache


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("family", FAMILIES)
def test_template_matches_model_decode_step(models, family, batch, stacked):
    _, _, tm, tp = models[family]
    cache, tok = _prefilled(tm, tp, batch)
    want, want_cache = tm.decode_step(tp, tok, cache)
    (got,), got_cache = _port_decode(tm, tp, cache, tok, stacked=stacked,
                                     steps=1)
    _close(got[:, None], want)
    assert torch.equal(got.argmax(-1), want[:, -1].argmax(-1))
    assert sorted(got_cache["layers"]) == sorted(want_cache["layers"])
    for k, v in want_cache["layers"].items():
        _close(got_cache["layers"][k], v)
        assert got_cache["layers"][k].dtype == v.dtype
    assert torch.equal(got_cache["pos"], want_cache["pos"])


def _moe_multistack(E=2):
    """grok smoke at 8 layers with gemma3's local/global period, so an MoE
    model has sub-stacks of 5, 1 and 2 layers (bodies with Lsub > 1)."""
    _, tcfg = _cfgs(f"moe-e{E}")
    cfg = dataclasses.replace(tcfg, num_layers=8, window_size=8,
                              global_every=6)
    m = Model(cfg, param_dtype=torch.float32, device="cpu")
    return m, m.init(torch.Generator().manual_seed(6))


@pytest.mark.parametrize("batch", [1, 2, 4])
@pytest.mark.parametrize("family", FAMILIES + ("moe-multistack",))
def test_stacked_decode_bitwise_equal_to_per_layer(models, family, batch):
    if family == "moe-multistack":
        tm, tp = _moe_multistack()
    else:
        _, _, tm, tp = models[family]
    cache, tok = _prefilled(tm, tp, batch)
    want, want_cache = _port_decode(tm, tp, cache, tok, stacked=False)
    got, got_cache = _port_decode(tm, tp, cache, tok, stacked=True)
    for s, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), f"logits of step {s}"
    assert torch.equal(got_cache["pos"], want_cache["pos"])
    for leaf in want_cache["layers"]:
        assert torch.equal(got_cache["layers"][leaf],
                           want_cache["layers"][leaf]), leaf


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_template_matches_reference_per_layer(models, family, stacked):
    jm, jp, tm, tp = models[family]
    prompt, tok = _inputs(tm.cfg.vocab_size, 2)
    _, jcache = jm.prefill(jp, {"tokens": jnp.asarray(prompt)}, cache_len=CL)
    tcache, ttok = _prefilled(tm, tp, 2)
    got, got_cache = _port_decode(tm, tp, tcache, ttok, stacked=stacked)
    jtmpl = _builders(family)[0](jm, jp, 2, stacked=False)
    jtok = jnp.asarray(tok)
    for step, logits in enumerate(got):
        prog = jtmpl.bind(stream_id=0, tokens=jtok, cache=jcache)
        jjit.VLIWJit(JaxCostModel(JTPU), max_group=8).run([prog])
        _close(logits, prog.env["logits"])
        jtok = jnp.argmax(prog.env["logits"], axis=-1).astype(
            jnp.int32)[:, None]
        np.testing.assert_array_equal(torch.argmax(logits, -1).numpy(),
                                      np.asarray(jtok[:, 0]), err_msg=step)
        jcache = prog.env["cache"]
    for leaf in jcache["layers"]:
        _close(got_cache["layers"][leaf], jcache["layers"][leaf])


@pytest.mark.parametrize("family", FAMILIES + ("moe-multistack",))
def test_one_body_stage_per_sub_stack(models, family):
    if family == "moe-multistack":
        tm, tp = _moe_multistack()
    else:
        _, _, tm, tp = models[family]
    cfg = tm.cfg
    build = _builders("ssm" if cfg.arch_type == "ssm" else "moe")[1]
    B = 2
    stages = build(tm, tp, B, stacked=True).stages
    bodies = [s for s in stages if isinstance(s, tjit.StackedGemmStage)]
    per_layer = build(tm, tp, B, stacked=False).stages
    assert not any(isinstance(s, tjit.StackedGemmStage) for s in per_layer)
    if cfg.arch_type == "ssm":
        assert [(b.tag, b.layers) for b in bodies] == \
            [(f"body_0_{cfg.num_layers}", cfg.num_layers)]
        assert [od.tag for od in bodies[0].operands] == \
            ["ssm_in_proj", "ssm_out_proj"]
        assert sum(isinstance(s, tjit.GemmStage) for s in per_layer) == \
            2 * cfg.num_layers + 1
        return
    spans = tjit.partition_layers(cfg.global_layer_flags())
    assert [b.tag for b in bodies] == [f"body_{lo}_{hi}" for lo, hi in spans]
    E = cfg.moe.num_experts
    C = tjit.moe_lib.capacity(B, cfg.moe)
    for body, (lo, hi) in zip(bodies, spans):
        ops = {od.tag: od for od in body.operands}
        assert list(ops) == ["attn_wq", "attn_wk", "attn_wv", "attn_wo",
                             "expert_gate", "expert_up", "expert_down"]
        for tag in ("expert_gate", "expert_up", "expert_down"):
            od = ops[tag]
            assert (od.shape.layers, od.shape.m) == ((hi - lo) * E, C)
            assert tuple(od.weight_fn().shape[:1]) == ((hi - lo) * E,)
            assert od.guard[0] is tp["blocks"]["moe"][tag.replace(
                "expert_", "w_")]
    assert sum(isinstance(s, tjit.GemmStage) for s in per_layer) == \
        (4 + 3 * E) * cfg.num_layers + 1


def test_cache_keys_capture_identity(models):
    _, _, mm, pm = models["moe-e4"]
    _, _, ms, ps = models["ssm"]
    cm, cs = mm.init_cache(2, CL), ms.init_cache(2, CL)
    key = tjit.moe_program_cache_key
    assert key(mm, pm, 2, cm) == key(mm, pm, 2, mm.init_cache(2, CL))
    assert key(mm, pm, 2, cm) != key(mm, pm, 4, mm.init_cache(4, CL))
    assert key(mm, pm, 2, cm) != key(mm, pm, 2, cm, stacked=False)
    skey = tjit.ssm_program_cache_key
    assert skey(ms, ps, 2, cs) != skey(ms, ps, 4, ms.init_cache(4, CL))
    assert skey(ms, ps, 2, cs) != skey(ms, ps, 2, cs, stacked=False)
    assert key(mm, pm, 2, cm)[0] == "moe-decode"
    assert skey(ms, ps, 2, cs)[0] == "ssm-decode"


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("family", ["moe-e4", "ssm"])
def test_template_bind_bit_identical_to_fresh_build(models, family, stacked):
    """Binding a cached template gives the bits of a fresh build, step
    after step: the plan cache never changes a logit."""
    _, _, tm, tp = models[family]
    build = _builders(family)[1]
    cache, tok = _prefilled(tm, tp, 2)
    template = build(tm, tp, 2, stacked=stacked)
    c_f, c_b, t = cache, cache, tok
    for _ in range(2):
        fresh = build(tm, tp, 2, stacked=stacked).bind(
            stream_id=0, tokens=t, cache=c_f)
        bound = template.bind(stream_id=0, tokens=t, cache=c_b)
        tjit.VLIWJit(max_group=8).run([fresh])
        tjit.VLIWJit(max_group=8).run([bound])
        assert torch.equal(bound.env["logits"], fresh.env["logits"])
        c_f, c_b = fresh.env["cache"], bound.env["cache"]
        t = torch.argmax(bound.env["logits"], -1)[:, None]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _jax_prompt(cfg, req, rng=jax.random.PRNGKey(0)):
    """The JAX engine's prompt for ``req`` (its ``_make_prompt``)."""
    return np.array(jax.random.randint(jax.random.fold_in(rng, req.req_id),
                                       (1, req.prompt_len), 0,
                                       cfg.vocab_size))


def _port_engine(tenants, mode, **kw):
    return ServingEngine(
        [Tenant(n, m, p, cache_len=CL, max_batch=2) for n, m, p in tenants],
        mode=mode, device="cpu",
        prompt_fn=lambda t, r: torch.from_numpy(_jax_prompt(t.cfg, r)),
        **kw)


def _jax_engine(tenants, **kw):
    return JaxEngine([JaxTenant(n, m, p, cache_len=CL, max_batch=2)
                      for n, m, p in tenants], mode="vliw", **kw)


def _tokens(rep):
    return {r.req_id: list(r.tokens_out) for r in rep.requests}


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("family", ["moe-e2", "ssm"])
def test_steady_state_hit_rate_and_cached_identity(models, family, stacked):
    _, _, tm, tp = models[family]
    steps = 5      # decode steps of the request (max_new_tokens - 1)
    trace = [ServeRequest(0, "a", 0.0, 8, steps + 1, 1.0)]
    reps = {cap: _port_engine([("a", tm, tp)], "vliw", plan_capacity=cap,
                              stacked_layers=stacked).run(trace)
            for cap in (128, 0)}    # cached vs rebuilt every step
    assert _tokens(reps[128]) == _tokens(reps[0])
    j = reps[128].jit
    assert (j.plan_cache.misses, j.plan_cache.hits) == (1, steps - 1)
    assert j.plan_cache.invalidations == 0
    assert j.nondense_programs == steps
    # stable expert / projection views: no phantom hot-swap, steady hits
    d = j.dispatch
    assert d.weight_invalidations == 0 and d.retraces == 0
    assert d.weight_hits + d.weight_misses == d.dispatches
    assert d.weight_hit_rate >= (steps - 1) / steps - 1e-9


@pytest.mark.parametrize("stacked", [False, True])
def test_weight_hot_swap_trips_the_guards(models, stacked):
    _, _, tm, p_old = models["moe-e2"]
    p_new = tm.init(torch.Generator().manual_seed(77))
    trace1 = [ServeRequest(0, "a", 0.0, 8, 3, 1.0)]
    trace2 = [ServeRequest(1, "a", 0.0, 8, 3, 1.0)]
    eng = _port_engine([("a", tm, p_old)], "vliw", stacked_layers=stacked)
    eng.run(trace1)
    assert eng.jit.plan_cache.stats.invalidations == 0
    assert eng.jit.executor.stats.weight_invalidations == 0
    eng.tenants["a"].params = p_new          # weight hot-swap, same model
    swapped = eng.run(trace2)
    assert eng.jit.plan_cache.stats.invalidations >= 1
    assert eng.jit.executor.stats.weight_invalidations >= 1
    fresh = _port_engine([("a", tm, p_new)], "vliw",
                         stacked_layers=stacked).run(trace2)
    assert _tokens(swapped) == _tokens(fresh)


def test_same_params_moe_tenants_share_expert_operands(models):
    """Two tenants serving ONE MoE params tree, per-layer regime: their
    expert GEMMs coalesce with one weight key (one weight load), and the
    tokens are the time-multiplexed baseline's."""
    _, _, tm, tp = models["moe-e4"]
    cache, tok = _prefilled(tm, tp, 2)
    template = tjit.build_moe_decode_template(tm, tp, 2, stacked=False)
    progs = [template.bind(stream_id=i, tokens=tok, cache=cache)
             for i in range(2)]
    stats = tjit.VLIWJit(max_group=8).run(progs)
    assert stats.shared_dispatches > 0 and stats.expert_coalesced > 0
    assert torch.equal(progs[0].env["logits"], progs[1].env["logits"])
    trace = [ServeRequest(i, "ab"[i % 2], 0.0, 8, 3, 1.0) for i in range(4)]
    tenants = [("a", tm, tp), ("b", tm, tp)]
    v = _port_engine(tenants, "vliw", stacked_layers=False).run(trace)
    t = _port_engine(tenants, "time").run(trace)
    assert _tokens(v) == _tokens(t)
    assert v.jit.shared_dispatches > 0 and v.jit.expert_coalesced > 0
    assert v.jit.dispatch.weight_invalidations == 0


@pytest.mark.parametrize("weights", ["one tree", "distinct"])
@pytest.mark.parametrize("stacked", [False, True])
def test_expert_coalescing_matches_reference(stacked, weights):
    """Two MoE tenants on one params tree (their expert GEMMs share
    operands) or on two, one trace, one cost model: the port's engine makes
    the JAX engine's scheduling decisions and counts the same
    ``expert_coalesced``, ``nondense_programs`` and shared dispatches;
    per-layer, the tokens are the JAX engine's."""
    one = _make("moe-e4", seed=11)
    pairs = [one, one] if weights == "one tree" else \
        [one, _make("moe-e4", seed=12)]
    trace = [ServeRequest(i, "ab"[i % 2], 1e-6 * i, 8, 4, 1.0)
             for i in range(4)]
    jrep = _jax_engine([(n, jm, jp) for n, (jm, jp, _, _) in
                        zip("ab", pairs)], cost=JaxCostModel(JTPU),
                       stacked_layers=stacked).run(trace)
    trep = _port_engine([(n, tm, tp) for n, (_, _, tm, tp) in
                         zip("ab", pairs)], "vliw", cost=CostModel(TPUV5E),
                        stacked_layers=stacked).run(trace)
    assert trep.jit.expert_coalesced == jrep.jit.expert_coalesced > 0
    assert trep.jit.nondense_programs == jrep.jit.nondense_programs > 0
    assert trep.jit.superkernels == jrep.jit.superkernels
    assert trep.jit.shared_dispatches == jrep.jit.shared_dispatches
    assert (trep.jit.shared_dispatches > 0) == (weights == "one tree")
    assert trep.jit.mean_group == pytest.approx(jrep.jit.mean_group)
    assert trep.modeled_time_s == pytest.approx(jrep.modeled_time_s)
    if not stacked:
        assert _tokens(trep) == _tokens(jrep)


def test_mixed_fleet_tokens_across_modes_regimes_and_reference(models):
    """A dense + MoE + SSM fleet: identical greedy tokens in the three
    modes and both vliw regimes, equal to the JAX engine's per-layer
    (``stacked_layers=False``) tokens and to each tenant served alone; the
    MoE and SSM decode steps go through the JIT."""
    dense = _make_dense()
    fleet = {"dense": dense, "moe": models["moe-e2"], "ssm": models["ssm"]}
    trace = [ServeRequest(i, n, i * 1e-6, 16, 3, 10.0)
             for i, n in enumerate(fleet)]

    def port(mode, only=None, **kw):
        return _port_engine([(n, tm, tp) for n, (_, _, tm, tp) in
                             fleet.items() if only in (None, n)],
                            mode, **kw)

    toks = {}
    for key, eng in (("time", port("time")), ("batched", port("batched")),
                     ("stacked", port("vliw")),
                     ("per-layer", port("vliw", stacked_layers=False))):
        rep = eng.run(trace)
        toks[key] = _tokens(rep)
        assert all(len(t) == 3 for t in toks[key].values())
        if rep.jit is not None:
            assert rep.jit.nondense_programs >= 2
            assert rep.jit.superkernels > 0
    jrep = _jax_engine([(n, jm, jp) for n, (jm, jp, _, _) in fleet.items()],
                       stacked_layers=False).run(trace)
    for key in ("batched", "stacked", "per-layer"):
        assert toks[key] == toks["time"], key
    assert toks["time"] == _tokens(jrep)
    for i, name in enumerate(fleet):
        alone = port("batched", only=name).run(
            [r for r in trace if r.tenant == name])
        assert _tokens(alone) == {i: toks["time"][i]}


def _make_dense():
    jm = JaxModel(jax_smoke_config("gemma3-1b"), param_dtype=jnp.float32)
    jp = jm.init(jax.random.PRNGKey(4))
    tm = Model(smoke_config("gemma3-1b"), param_dtype=torch.float32,
               device="cpu")
    return jm, jp, tm, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")


# ---------------------------------------------------------------------------
# the executor's byte budget with expert packs (tests/test_nondense_programs
# .py's regressions, on the port's PlanCache and SuperkernelExecutor)
# ---------------------------------------------------------------------------

def _rand(seed, shape):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def _expert_ops(slot, n_experts, seed0, m=2, k=128, n=256):
    """One MoE expert-GEMM group: ``n_experts`` problems with distinct
    per-expert weights, the expert index in the weight key."""
    from repro_torch.core import GemmShape, make_op
    a = _rand(0, (m, k))
    ops = []
    for e in range(n_experts):
        op = make_op(slot, "gemv", GemmShape(m=m, n=n, k=k),
                     tag="expert_gate", seq_index=e)
        op.payload = (a, _rand(seed0 + e, (k, n)),
                      ("moe", slot, "w_gate", e))
        ops.append(op)
    return ops


def test_byte_budget_counts_full_stacked_expert_operand():
    """The cached value is the FULL stacked expert operand, G bucketed to
    a power of two, and ``PlanCache.bytes`` accounts every byte of it."""
    from repro_torch.core import PlanCache, SuperkernelExecutor
    cache = PlanCache(capacity=64, byte_capacity=1 << 30)
    ex = SuperkernelExecutor(cache, bm=8)
    ex.execute(_expert_ops(0, n_experts=3, seed0=10))   # G=3 -> G_pad=4
    assert cache.bytes == 4 * 128 * 256 * 4             # G_pad x K x N fp32
    assert cache.bytes == sum(int(e.value.nbytes)
                              for e in cache._entries.values())


def test_byte_budget_counts_a_layer_stacked_expert_pack(models):
    """A stacked MoE body's expert pack is [Lsub·E, K, N] at the bucketed
    envelope, and the budget counts all of it."""
    from repro_torch.core import PlanCache, SuperkernelExecutor
    _, _, tm, tp = models["moe-e4"]
    cfg = tm.cfg
    body = next(s for s in tjit.build_moe_decode_template(tm, tp, 2).stages
                if isinstance(s, tjit.StackedGemmStage))
    od = next(o for o in body.operands if o.tag == "expert_down")
    cache = PlanCache(capacity=8, byte_capacity=1 << 30)
    ex = SuperkernelExecutor(cache, bm=8)
    pack = ex.stacked_operand(od.weight_key, od.shape.k, od.shape.n,
                              od.shape.layers, od.weight_fn, od.guard)
    L, E = cfg.num_layers, cfg.moe.num_experts
    assert tuple(pack.shape) == (L * E, 256, 128)        # d_ff 256, d 128
    assert torch.equal(pack.reshape(L, E, 256, 128),
                       tp["blocks"]["moe"]["w_down"])
    assert cache.bytes == pack.nbytes == L * E * 256 * 128 * 4


def test_byte_budget_evicts_expert_packs_lru():
    """Expert packs past the byte budget evict LRU-first: the newest stay
    resident (re-dispatching them hits), the oldest miss."""
    from repro_torch.core import PlanCache, SuperkernelExecutor
    pack = 4 * 128 * 256 * 4
    cache = PlanCache(capacity=64, byte_capacity=3 * pack + 1)
    ex = SuperkernelExecutor(cache, bm=8)
    groups = [_expert_ops(i, n_experts=3, seed0=100 + 10 * i)
              for i in range(5)]
    for g in groups:
        ex.execute(g)
    assert cache.bytes <= 3 * pack + 1
    assert cache.stats.evictions == 2            # slots 0 and 1 reclaimed
    misses0 = ex.stats.weight_misses
    ex.execute(groups[-1])                       # newest: resident -> hit
    assert ex.stats.weight_misses == misses0
    assert ex.stats.weight_hits >= 1
    ex.execute(groups[0])                        # oldest: evicted -> miss
    assert ex.stats.weight_misses == misses0 + 1


def test_oversized_pack_passes_through_without_wiping_cache():
    """A pack bigger than the whole byte budget is served but not kept,
    and the resident packs stay."""
    from repro_torch.core import PlanCache
    small = _rand(1, (64, 64))                   # 16 KiB
    cache = PlanCache(capacity=64, byte_capacity=4 * small.nbytes)
    for i in range(3):
        cache.get_or_build(("small", i), lambda: small)
    bytes0 = cache.bytes
    giant = _rand(2, (512, 512))                 # 1 MiB >> budget
    out = cache.get_or_build(("giant",), lambda: giant)
    assert out is giant
    assert ("giant",) not in cache
    assert len(cache) == 3 and cache.bytes == bytes0
    assert cache.stats.evictions == 0
    hits0 = cache.stats.hits
    cache.get_or_build(("small", 0), lambda: None)
    assert cache.stats.hits == hits0 + 1


def test_converted_fp32_leaves_stay_fp32():
    """A bf16 JAX tree carried across keeps the router and the SSM's
    dt_bias, A_log and D in fp32, bit for bit."""
    for arch, leaves in (("grok-1-314b", (("moe", "router"),)),
                         ("mamba2-2.7b", (("mamba", "dt_bias"),
                                          ("mamba", "A_log"),
                                          ("mamba", "D")))):
        jm = JaxModel(jax_smoke_config(arch), param_dtype=jnp.bfloat16)
        jp = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(2)))
        tp = params_from_numpy(jp, device="cpu")
        assert tp["embed"].dtype == torch.bfloat16
        for group, name in leaves:
            got = tp["blocks"][group][name]
            assert got.dtype == torch.float32, (arch, name)
            np.testing.assert_array_equal(got.numpy(),
                                          jp["blocks"][group][name])
