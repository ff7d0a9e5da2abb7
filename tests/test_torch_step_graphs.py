"""The rest of the compiled serving path as CUDA graphs, on the CPU: the
stacked prefill bodies, the monolithic ``Model.decode_step`` /
``Model.prefill`` calls and the per-layer glue (``repro_torch/core/
graphs.py``), against their eager twins (``cuda_graphs=False``) and the
JAX package.

A CPU has no CUDA graph, so the jit's cache is swapped for one whose
capture is a stand-in (``StandIn``, as in tests/test_torch_graphs.py): its
"capture" runs the call once on the static inputs, its replay runs it again
into the static outputs. Everything around the graph is the code the card
runs: the keys, the copy-in and copy-out, the weak operands, the counters.
Smoke configs, fp32, 2–8 layers, weights made by the JAX package and
carried across with ``params_from_numpy``.

  * The prompt-body key: distinct per bucket and weight set; shared by two
    tenants on one weight set and by requests of different lengths in one
    bucket (captures = bodies × buckets, the rest replays).
  * Replays bitwise equal to eager: prompt bodies (and the per-layer
    oracle), monolithic ``decode_step`` / ``prefill`` of the hybrid, audio,
    int8-KV and vlm families, the per-layer glue of dense, MoE and SSM
    decode and dense prefill (one graph a ``_GLUE_JITS`` key).
  * A dense + MoE + SSM + hybrid + audio + int8-KV fleet: tokens identical
    with graphs on, with graphs off and on the JAX engine (its Pallas
    kernels in interpret mode) in ``vliw`` (both regimes), ``batched`` and
    ``time``; after one per-layer run, the glue graphs' keys are the JAX
    package's ``_GLUE_JITS`` keys, names mapped.
  * A hot-swap drops the old monolithic graph and frees the old params.
  * The real ``GraphCache`` never captures on the CPU.
  * ``_embed_scale`` is made once per (d_model, device, dtype), bitwise
    the value it was.
"""
import dataclasses
import gc
import math
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.jit as jax_jit
from repro.configs import MoEConfig as JaxMoEConfig
from repro.configs import smoke_config as jax_smoke_config
from repro.core.costmodel import CostModel as JaxCostModel, TPUV5E as JTPU
from repro.models import Model as JaxModel
from repro.serving import ServingEngine as JaxEngine, Tenant as JaxTenant
from repro_torch.configs import MoEConfig, smoke_config
from repro_torch.core import jit as tjit
from repro_torch.core.costmodel import CostModel, TPUV5E
from repro_torch.core.graphs import KINDS, GraphCache, _counters, _restore
from repro_torch.models import Model
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import ServeRequest, ServingEngine, Tenant

CL = 48
# name -> (arch, kv_quant)
ARCHS = {"dense": ("gemma3-1b", False), "moe": ("grok-1-314b", False),
         "ssm": ("mamba2-2.7b", False), "hybrid": ("hymba-1.5b", False),
         "audio": ("whisper-tiny", False), "int8": ("gemma3-1b", True),
         "vlm": ("internvl2-2b", False)}
FLEET = ("dense", "moe", "ssm", "hybrid", "audio", "int8")


class StandIn:
    """A CPU stand-in for one captured call: its replay reruns the call on
    the static inputs into the static outputs and, like a graph, leaves the
    kernels' launch counters as they were."""

    def __init__(self, fn, static_in, stream, pool):
        self.fn, self.static_in = fn, static_in
        self.static_out = fn(static_in)

    def replay(self):
        counts = _counters()
        for name, t in self.fn(self.static_in).items():
            self.static_out[name].copy_(t)
        _restore(counts)


def _stand_in(jit):
    """Give ``jit`` a graph cache of stand-ins, wired to its weight cache
    as the real one is."""
    jit.weight_cache.on_drop.remove(jit.graphs.drop_operand)
    jit.graphs = GraphCache(capture=StandIn, resident=jit.weight_cache.holds)
    jit.weight_cache.on_drop.append(jit.graphs.drop_operand)
    return jit.graphs


def _cfgs(name):
    """(JAX config, port config): smoke configs; the dense tenant at 8
    layers with one global layer in six (bodies of 5, 1 and 2 layers), the
    MoE tenant with 2 experts top-2."""
    arch, _ = ARCHS[name]
    jc, tc = jax_smoke_config(arch), smoke_config(arch)
    if name == "dense":
        return (dataclasses.replace(jc, num_layers=8, global_every=6),
                dataclasses.replace(tc, num_layers=8, global_every=6))
    if name == "moe":
        return (dataclasses.replace(jc, moe=JaxMoEConfig(num_experts=2,
                                                         top_k=2)),
                dataclasses.replace(tc, moe=MoEConfig(num_experts=2,
                                                      top_k=2)))
    return jc, tc


def _make(name, seed):
    jcfg, tcfg = _cfgs(name)
    kvq = ARCHS[name][1]
    jm = JaxModel(jcfg, param_dtype=jnp.float32, kv_quant=kvq)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = Model(tcfg, param_dtype=torch.float32, device="cpu", kv_quant=kvq)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def models():
    return {name: _make(name, seed) for seed, name in enumerate(ARCHS)}


def _jax_prompt(cfg, req, rng=jax.random.PRNGKey(0)):
    return np.array(jax.random.randint(jax.random.fold_in(rng, req.req_id),
                                       (1, req.prompt_len), 0,
                                       cfg.vocab_size))


def _port_engine(tenants, mode, graphed, **kw):
    """A port engine on the CPU: ``graphed`` swaps in stand-in graphs,
    else ``cuda_graphs=False`` (the eager twin)."""
    eng = ServingEngine(
        [Tenant(n, tm, tp, cache_len=CL, max_batch=2) for n, tm, tp in
         tenants],
        mode=mode, cost=CostModel(TPUV5E), device="cpu",
        cuda_graphs=graphed,
        prompt_fn=lambda t, r: torch.from_numpy(_jax_prompt(t.cfg, r)),
        **kw)
    if graphed:
        _stand_in(eng.jit)
    return eng


def _tokens(rep):
    return {r.req_id: list(r.tokens_out) for r in rep.requests}


def _bodies(template):
    return [st for st in template.stages
            if isinstance(st, tjit.StackedGemmStage)]


def _kinds(stats):
    return stats.graphs_by_kind()


# ---------------------------------------------------------------------------
# the stacked prefill bodies
# ---------------------------------------------------------------------------

def test_prompt_body_key_per_bucket_and_weight_set(models):
    _, _, tm, tp = models["dense"]
    other = tm.init(torch.Generator().manual_seed(5))
    packs = {"attn_wq": torch.zeros(1)}

    def keys(params, Sp):
        env = {"x": torch.zeros(Sp, tm.cfg.d_model),
               "positions": torch.arange(Sp)[None]}
        tmpl = tjit.build_dense_prefill_template(tm, params, Sp)
        return [GraphCache.key(st, st.graph.read(env), packs, 8)
                for st in _bodies(tmpl)]

    k32 = keys(tp, 32)
    assert len(k32) == 3 and len(set(k32)) == 3
    assert all(k[0] == "prefill" and k[1][0] == ("prefill", tm.cfg, 32)
               for k in k32)
    assert keys(tp, 32) == k32                       # a second tenant
    assert not set(keys(tp, 64)) & set(k32)          # per bucket
    assert not set(keys(other, 32)) & set(k32)       # per weight set


def test_prompt_bodies_shared_by_tenants_and_lengths_in_a_bucket(models):
    """Two tenants on one weight set, prompts of 17, 20 and 31 tokens
    (bucket 32) and 40 (bucket 64): one prompt graph a body and bucket,
    every other prompt pass a replay; tokens equal the eager run's."""
    _, _, tm, tp = models["dense"]
    lens = (17, 20, 31, 40, 17, 31)
    trace = [ServeRequest(i, "ab"[i % 2], 1e-6 * i, n, 3, 10.0)
             for i, n in enumerate(lens)]
    reps, engines = {}, {}
    for graphed in (True, False):
        eng = engines[graphed] = _port_engine(
            [("a", tm, tp), ("b", tm, tp)], "vliw", graphed)
        reps[graphed] = eng.run(trace)
    assert _tokens(reps[True]) == _tokens(reps[False])
    bodies = len(_bodies(tjit.build_dense_prefill_template(tm, tp, 32)))
    graphs = engines[True].jit.graphs
    assert graphs.count("prefill") == 2 * bodies
    assert {h[0] for h in graphs.heads("prefill")} == {
        ("prefill", tm.cfg, 32), ("prefill", tm.cfg, 64)}
    kinds = _kinds(reps[True].jit.dispatch)
    assert kinds["prefill"] == (2 * bodies, (len(lens) - 2) * bodies)
    assert kinds["monolithic"] == kinds["glue"] == (0, 0)
    assert _kinds(reps[False].jit.dispatch) == {k: (0, 0) for k in KINDS}


def test_prompt_body_replays_bitwise_equal_to_eager(models):
    """Prompt passes of three lengths in one bucket through the stacked
    prefill template, as replays and eagerly: logits and the written cache
    bitwise equal, and equal to the per-layer template's."""
    _, _, tm, tp = models["dense"]
    cache0 = tm.init_cache(2, CL)
    jits = {"graphed": tjit.VLIWJit(CostModel(TPUV5E)),
            "eager": tjit.VLIWJit(CostModel(TPUV5E), cuda_graphs=False),
            "per-layer": tjit.VLIWJit(CostModel(TPUV5E))}
    graphs = _stand_in(jits["graphed"])
    _stand_in(jits["per-layer"])
    out = {}
    for regime, jit in jits.items():
        tmpl = tjit.build_dense_prefill_template(
            tm, tp, 32, stacked=regime != "per-layer")
        cache, logits = cache0, []
        rng = np.random.default_rng(2)
        for i, S in enumerate((20, 32, 17)):
            toks = torch.zeros((1, 32), dtype=torch.long)
            toks[0, :S] = torch.from_numpy(
                rng.integers(0, tm.cfg.vocab_size, S))
            prog = tmpl.bind(stream_id=0, tokens=toks, cache=cache,
                             env_extra={"real_len": S, "slot": i % 2,
                                        "req": None})
            jit.run([prog])
            logits.append(prog.env["logits"])
            cache = prog.env["cache"]
        out[regime] = (logits, cache)
    for regime in ("eager", "per-layer"):
        for a, b in zip(out["graphed"][0], out[regime][0]):
            assert torch.equal(a, b), regime
        for leaf, t in out[regime][1]["layers"].items():
            assert torch.equal(out["graphed"][1]["layers"][leaf], t), leaf
    bodies = graphs.count("prefill")
    assert bodies == 3
    assert _kinds(jits["graphed"].executor.stats)["prefill"] == (3, 6)
    # the per-layer prefill: one prefill-attend graph a key, replays after
    per_layer = _kinds(jits["per-layer"].executor.stats)
    n_keys = len(jits["per-layer"].graphs.heads("glue"))
    assert n_keys == 2                     # local and global layers
    assert per_layer["glue"] == (n_keys, 3 * 8 - n_keys)


# ---------------------------------------------------------------------------
# the monolithic model calls
# ---------------------------------------------------------------------------

def _pbatch(m, S, rng):
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, m.cfg.vocab_size, (1, S))).long()}
    if m.cfg.arch_type == "vlm":
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (1, m.cfg.num_patch_tokens, m.cfg.d_model)).astype(np.float32))
    if m.cfg.is_encdec:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (1, m.cfg.encoder_seq_len, m.cfg.d_model)).astype(np.float32))
    return batch


def _same_tree(a, b, where):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same_tree(a[k], b[k], f"{where}/{k}")
    else:
        assert torch.equal(a, b), where


@pytest.mark.parametrize("name", ["hybrid", "audio", "int8", "vlm"])
def test_monolithic_replays_bitwise_equal_to_eager(models, name):
    """Three prompts and three decode steps of one tenant through the
    engine's monolithic calls, as replays and as the plain model calls:
    logits and every cache leaf bitwise equal; one graph a call shape."""
    _, _, tm, tp = models[name]
    eng = _port_engine([(name, tm, tp)], "batched", True)
    t = eng.tenants[name]
    rng = np.random.default_rng(4)
    for _ in range(3):
        batch = _pbatch(tm, 12, rng)
        got = eng._prefill(t, batch)
        want = tm.prefill(tp, batch, cache_len=CL)
        assert torch.equal(got[0], want[0])
        _same_tree(got[1], want[1], "prefill")
    t.cache = tm.init_cache(2, CL)
    t.cache = {"pos": t.cache["pos"] + 5, "layers": {
        k: (v if v.dtype == torch.int8 else v + 0.1)
        for k, v in t.cache["layers"].items()}}
    for step in range(3):
        t.slot_tok = torch.from_numpy(
            rng.integers(0, tm.cfg.vocab_size, (2, 1))).long()
        want = tm.decode_step(tp, t.slot_tok, t.cache)
        got = eng._decode_step(t)
        assert torch.equal(got[0], want[0]), step
        _same_tree(got[1], want[1], f"decode {step}")
        t.cache = got[1]
    stats = eng.jit.executor.stats
    assert _kinds(stats)["monolithic"] == (2, 4)
    assert stats.graph_captures == stats.graph_replays == 0
    heads = eng.jit.graphs.heads("monolithic")
    assert heads == {("prefill", tm.cfg, "float32", tm.kv_quant, CL),
                     ("decode_step", tm.cfg, "float32", tm.kv_quant)}


# ---------------------------------------------------------------------------
# the per-layer glue
# ---------------------------------------------------------------------------

def _decode_builder(name):
    return {"dense": tjit.build_dense_decode_template,
            "moe": tjit.build_moe_decode_template,
            "ssm": tjit.build_ssm_decode_template}[name]


@pytest.mark.parametrize("name", ["dense", "moe", "ssm"])
def test_per_layer_glue_replays_bitwise_equal_to_eager(models, name):
    """Three per-layer decode steps with the glue replayed and eager, and
    the stacked template: logits and caches bitwise equal; one glue graph
    a ``_GLUE_JITS`` key, every other glue stage a replay of it."""
    _, _, tm, tp = models[name]
    rng = np.random.default_rng(6)
    prompt = torch.from_numpy(rng.integers(0, tm.cfg.vocab_size, (2, 8)))
    _, cache0 = tm.prefill(tp, {"tokens": prompt.long()}, cache_len=CL)
    tok0 = torch.from_numpy(rng.integers(0, tm.cfg.vocab_size, (2, 1)))
    out, jits = {}, {}
    for regime in ("glue-graphed", "eager", "stacked"):
        jit = jits[regime] = tjit.VLIWJit(
            CostModel(TPUV5E), cuda_graphs=regime == "glue-graphed")
        if regime == "glue-graphed":
            _stand_in(jit)
        tmpl = _decode_builder(name)(tm, tp, 2,
                                     stacked=regime == "stacked")
        cache, tok, logits = cache0, tok0.long(), []
        for _ in range(3):
            prog = tmpl.bind(stream_id=0, tokens=tok, cache=cache)
            jit.run([prog])
            logits.append(prog.env["logits"])
            cache = prog.env["cache"]
            tok = torch.argmax(prog.env["logits"], -1)[:, None]
        out[regime] = (logits, cache)
    for regime in ("eager", "stacked"):
        for a, b in zip(out["glue-graphed"][0], out[regime][0]):
            assert torch.equal(a, b), regime
        _same_tree(out["glue-graphed"][1], out[regime][1], regime)
    heads = jits["glue-graphed"].graphs.heads("glue")
    cfg, B = tm.cfg, 2
    L = cfg.num_layers
    attend = {("decode-attend", cfg, B, bool(cfg.layer_is_global(l)),
               "float32") for l in range(L)}
    if name == "dense":
        want = attend
        assert len(want) == 2              # local and global layers
    elif name == "moe":
        want = attend | {("moe-route", cfg, B, tmoe.capacity(B, cfg.moe)),
                         ("moe-combine", cfg, B)}
    else:
        want = {("ssm-core", cfg)}
    assert heads == want
    runs = {"dense": L, "moe": 3 * L, "ssm": L}[name] * 3
    assert _kinds(jits["glue-graphed"].executor.stats)["glue"] == (
        len(want), runs - len(want))
    assert _kinds(jits["eager"].executor.stats)["glue"] == (0, 0)


# ---------------------------------------------------------------------------
# a fleet of every family, graphs on and off, and the JAX engine
# ---------------------------------------------------------------------------

def _trace():
    """Two requests a tenant, 16-token prompts (the dense tenant declares
    its prompt passes), 3 new tokens."""
    return [ServeRequest(i, name, 1e-6 * i, 16, 3, 10.0)
            for i, name in enumerate(FLEET * 2)]


@pytest.fixture(scope="module")
def fleet_runs(models):
    port = [(n, models[n][2], models[n][3]) for n in FLEET]
    out = {}
    for mode, kw in (("vliw", {}), ("per-layer", {"stacked_layers": False}),
                     ("batched", {}), ("time", {})):
        emode = "vliw" if mode == "per-layer" else mode
        runs = {}
        for graphed in (True, False):
            eng = _port_engine(port, emode, graphed, **kw)
            runs[graphed] = (eng.run(_trace()), eng)
        # the reference's glue jits of this run only: its memo is cleared
        # for the run and given back its entries after
        saved = dict(jax_jit._GLUE_JITS)
        jax_jit._GLUE_JITS.clear()
        jax_tenants = [JaxTenant(n, models[n][0], models[n][1],
                                 cache_len=CL, max_batch=2) for n in FLEET]
        jrep = JaxEngine(jax_tenants, mode=emode, cost=JaxCostModel(JTPU),
                         **kw).run(_trace())
        out[mode] = (runs, jrep, set(jax_jit._GLUE_JITS))
        jax_jit._GLUE_JITS.update(saved)
    return out


@pytest.mark.parametrize("mode", ["vliw", "per-layer", "batched", "time"])
def test_fleet_tokens_graphed_eager_and_reference(fleet_runs, mode):
    runs, jrep, _ = fleet_runs[mode]
    graphed, eager = (_tokens(runs[g][0]) for g in (True, False))
    assert all(len(t) == 3 for t in graphed.values())
    assert len(graphed) == 2 * len(FLEET)
    assert graphed == eager == _tokens(jrep)
    assert graphed == _tokens(fleet_runs["vliw"][1])
    # what each mode graphs
    stats = {g: runs[g][1].jit.executor.stats for g in (True, False)}
    assert all(v == (0, 0) for v in _kinds(stats[False]).values())
    kinds = _kinds(stats[True])
    n_mono = 3 if mode in ("vliw", "per-layer") else len(FLEET)
    assert kinds["monolithic"][0] >= n_mono
    if mode == "vliw":
        assert kinds["decode"][0] > 0 and kinds["prefill"][0] > 0
        assert kinds["glue"] == (0, 0)
    elif mode == "per-layer":
        assert kinds["glue"][0] > 0 and kinds["glue"][1] > 0
        assert kinds["decode"] == kinds["prefill"] == (0, 0)
    else:
        assert kinds["decode"] == kinds["prefill"] == kinds["glue"] == (0, 0)


def test_glue_graph_keys_are_the_references_glue_jits(fleet_runs):
    """After one per-layer run of the fleet, the glue graphs' keys are the
    keys of the JAX package's ``_GLUE_JITS`` after the same run, with each
    config named by its ``name`` and each dtype by its name."""
    runs, _, jax_keys = fleet_runs["per-layer"]
    port_keys = runs[True][1].jit.graphs.heads("glue")

    def named(key):
        return tuple(k.name if dataclasses.is_dataclass(k) else
                     (str(k) if not isinstance(k, (int, bool, str)) else k)
                     for k in key)

    assert jax_keys
    assert {named(k) for k in port_keys} == {named(k) for k in jax_keys}
    assert {k[0] for k in port_keys} == {
        "decode-attend", "prefill-attend", "moe-route", "moe-combine",
        "ssm-core"}


# ---------------------------------------------------------------------------
# hot-swap, the real cache on the CPU, the embed scale
# ---------------------------------------------------------------------------

def test_hot_swap_drops_the_old_monolithic_graph_and_frees_the_params(
        models):
    _, _, tm, _ = models["hybrid"]
    p_old = tm.init(torch.Generator().manual_seed(21))
    p_new = tm.init(torch.Generator().manual_seed(22))
    trace = [ServeRequest(i, "h", 1e-6 * i, 12, 3, 10.0) for i in range(2)]
    eng = _port_engine([("h", tm, p_old)], "batched", True)
    graphs = eng.jit.graphs
    before = _tokens(eng.run(trace))
    assert graphs.count("monolithic") == 2          # prefill, decode_step
    old = weakref.ref(p_old["blocks"]["attn"]["wq"])
    eng.tenants["h"].params = p_new                  # weight hot-swap
    del p_old
    gc.collect()
    assert old() is None                             # no graph held them
    assert graphs.count("monolithic") == 0 and graphs.dropped == 2
    swapped = _tokens(eng.run(trace))
    assert graphs.count("monolithic") == 2
    fresh = _port_engine([("h", tm, p_new)], "batched", False)
    assert swapped == _tokens(fresh.run(trace))
    assert all(len(v) == 3 for v in before.values())


def test_real_cache_never_captures_on_the_cpu(models):
    port = [(n, models[n][2], models[n][3]) for n in ("dense", "hybrid")]
    for mode, kw in (("vliw", {}), ("vliw", {"stacked_layers": False}),
                     ("batched", {})):
        eng = ServingEngine(
            [Tenant(n, tm, tp, cache_len=CL, max_batch=2)
             for n, tm, tp in port], mode=mode, device="cpu", **kw)
        assert eng.jit.cuda_graphs
        rep = eng.run([ServeRequest(i, n, 0.0, 16, 2, 10.0)
                       for i, (n, _, _) in enumerate(port)])
        assert all(len(r.tokens_out) == 2 for r in rep.requests)
        assert len(eng.jit.graphs) == 0
        assert all(v == (0, 0) for v in
                   _kinds(eng.jit.executor.stats).values())


def test_embed_scale_made_once_and_bitwise_unchanged():
    cfg = smoke_config("gemma3-1b")
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.zeros(2, dtype=dtype)
        a, b = tjit._embed_scale(cfg, x), tjit._embed_scale(cfg, x)
        assert a is b and a.dtype == dtype
        want = torch.tensor(math.sqrt(cfg.d_model),
                            dtype=torch.float32).to(dtype)
        assert torch.equal(a, want)
