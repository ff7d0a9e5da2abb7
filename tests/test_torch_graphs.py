"""The stacked decode bodies' CUDA graphs (``repro_torch/core/graphs.py``)
and the two changes that make the bodies capturable, on the CPU.

A CPU has no CUDA graph, so the cache is driven with a stand-in capture
(``StandIn``): its "capture" runs the body once on the static inputs and
keeps the function, its replay runs it again and writes the static
outputs in place, as a graph writes its static buffers. Everything around
the graph is the code the card runs: the key, the copy-in and copy-out, the
weight cache's drops and the kernel counters.

  * The key: distinct per body, batch, bm and pack identity; equal for two
    tenants on one weight set, which then share one graph.
  * Replays bitwise equal to the eager body (dense, MoE, SSM, 3 steps), a
    capture a body key and replays after it; two tenants on one graph keep
    each other's caches intact; a replay adds its capture's launches to the
    kernel counters.
  * Eviction, invalidation and a hot-swap of a stacked pack drop the graphs
    that read it, and the dropped pack is freed.
  * The real cache on the CPU never captures, and a fleet's tokens stay
    the JAX engine's.
  * The fixed-shape MoE dispatch: bitwise equal to the masked version it
    replaced over seeded routings with capacity drops, and to the JAX
    package's ``dispatch_tokens`` / ``combine_tokens``.
  * q·kᵀ: the card's route (one batched product, bf16 in, fp32 out) and the
    CPU's widened einsum against the JAX package's
    ``preferred_element_type=float32`` einsum within the bf16 tolerance of
    tests/test_kernels.py; fp32 bitwise unchanged; the route's backward
    against autograd of the widened einsum.
"""
import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import MoEConfig as JaxMoEConfig
from repro.configs import smoke_config as jax_smoke_config
from repro.core.costmodel import CostModel as JaxCostModel, TPUV5E as JTPU
from repro.models import Model as JaxModel
from repro.models import moe as jmoe
from repro.serving import ServingEngine as JaxEngine, Tenant as JaxTenant
from repro_torch.configs import MoEConfig, smoke_config
from repro_torch.core import jit as tjit
from repro_torch.core.costmodel import CostModel, TPUV5E
from repro_torch.core.graphs import BodyIO, GraphCache, _counters, _restore
from repro_torch.kernels.coalesced_gemm import coalesced_gemm
from repro_torch.models import Model
from repro_torch.models import moe as tmoe
from repro_torch.models.attention import _bmm_scores, qk_scores
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import ServeRequest, ServingEngine, Tenant

CL = 32
FAMILIES = ("dense", "moe", "ssm")


class StandIn:
    """A CPU stand-in for one captured body (see the module docstring). Like
    a graph, its replay calls no kernel wrapper, so it leaves the launch
    counters as they were."""

    def __init__(self, fn, static_in, stream, pool):
        self.fn, self.static_in = fn, static_in
        self.static_out = fn(static_in)

    def replay(self):
        counts = _counters()
        for name, t in self.fn(self.static_in).items():
            self.static_out[name].copy_(t)
        _restore(counts)


def _stand_in(jit):
    """Give ``jit`` a graph cache whose captures are stand-ins, wired to its
    weight cache as the real one is."""
    jit.weight_cache.on_drop.remove(jit.graphs.drop_operand)
    jit.graphs = GraphCache(capture=StandIn, resident=jit.weight_cache.holds)
    jit.weight_cache.on_drop.append(jit.graphs.drop_operand)
    return jit.graphs


def _cfgs(family):
    """(JAX config, port config): gemma3-1b smoke at 8 layers with one
    global layer in six (bodies of 5, 1 and 2 layers), grok-1 smoke with
    2 experts top-2, mamba2-2.7b smoke."""
    if family == "dense":
        jc, tc = jax_smoke_config("gemma3-1b"), smoke_config("gemma3-1b")
        return (dataclasses.replace(jc, num_layers=8, global_every=6),
                dataclasses.replace(tc, num_layers=8, global_every=6))
    if family == "ssm":
        return jax_smoke_config("mamba2-2.7b"), smoke_config("mamba2-2.7b")
    jc, tc = jax_smoke_config("grok-1-314b"), smoke_config("grok-1-314b")
    return (dataclasses.replace(jc, moe=JaxMoEConfig(num_experts=2, top_k=2)),
            dataclasses.replace(tc, moe=MoEConfig(num_experts=2, top_k=2)))


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


def _builder(family):
    return {"dense": tjit.build_dense_decode_template,
            "moe": tjit.build_moe_decode_template,
            "ssm": tjit.build_ssm_decode_template}[family]


def _prefilled(tm, tp, B, seed=3):
    rng = np.random.default_rng(seed)
    V = tm.cfg.vocab_size
    prompt = torch.from_numpy(rng.integers(0, V, (B, 8))).long()
    _, cache = tm.prefill(tp, {"tokens": prompt}, cache_len=CL)
    tok = torch.from_numpy(rng.integers(0, V, (B, 1))).long()
    return cache, tok


def _bodies(template):
    return [st for st in template.stages
            if isinstance(st, tjit.StackedGemmStage)]


def _decode(jit, template, cache, tok, steps=3):
    logits = []
    for _ in range(steps):
        prog = template.bind(stream_id=0, tokens=tok, cache=cache)
        jit.run([prog])
        logits.append(prog.env["logits"])
        cache = prog.env["cache"]
        tok = torch.argmax(prog.env["logits"], dim=-1)[:, None]
    return logits, cache


def _assert_same(a_logits, a_cache, b_logits, b_cache):
    for s, (x, y) in enumerate(zip(a_logits, b_logits)):
        assert torch.equal(x, y), f"logits of step {s}"
    assert torch.equal(a_cache["pos"], b_cache["pos"])
    for leaf in b_cache["layers"]:
        assert torch.equal(a_cache["layers"][leaf],
                           b_cache["layers"][leaf]), leaf


# ---------------------------------------------------------------------------
# the key
# ---------------------------------------------------------------------------

def test_key_distinct_per_body_batch_bm_and_operand(models):
    _, _, tm, tp = models["dense"]
    cache, _ = _prefilled(tm, tp, 2)
    env = {"x": torch.zeros(2, tm.cfg.d_model), "cache": cache}
    t2a = tjit.build_dense_decode_template(tm, tp, 2)
    t2b = tjit.build_dense_decode_template(tm, tp, 2)   # a second tenant
    t4 = tjit.build_dense_decode_template(tm, tp, 4)
    cache4, _ = _prefilled(tm, tp, 4)
    env4 = {"x": torch.zeros(4, tm.cfg.d_model), "cache": cache4}
    packs = {"attn_wq": torch.zeros(1), "ffn_up": torch.zeros(1)}

    def key(st, e=env, padded=packs, bm=8):
        return GraphCache.key(st, st.graph.read(e), padded, bm)

    bodies = _bodies(t2a)
    assert len(bodies) == 3 and all(st.graph is not None for st in bodies)
    keys = [key(st) for st in bodies]
    assert len(set(keys)) == 3                              # per body
    assert [key(st) for st in _bodies(t2b)] == keys         # two tenants
    assert key(_bodies(t4)[0], env4) != keys[0]             # per batch
    assert key(bodies[0], bm=16) != keys[0]                 # per bm
    repacked = dict(packs, ffn_up=torch.zeros(1))
    assert key(bodies[0], padded=repacked) != keys[0]       # per operand
    # a new weight set of one model: another body key
    t_new = tjit.build_dense_decode_template(
        tm, tm.init(torch.Generator().manual_seed(9)), 2)
    assert key(_bodies(t_new)[0]) != keys[0]
    # prefill bodies are captured too, under keys of their own kind
    # (tests/test_torch_step_graphs.py holds their keys)
    pre = tjit.build_dense_prefill_template(tm, tp, 8)
    env8 = {"x": torch.zeros(8, tm.cfg.d_model),
            "positions": torch.arange(8)[None]}
    pkeys = [key(st, env8) for st in _bodies(pre)]
    assert all(k[0] == "prefill" for k in pkeys)
    assert len(set(pkeys)) == 3 and not set(pkeys) & set(keys)


def test_two_tenants_on_one_weight_set_share_one_graph(models):
    _, _, tm, tp = models["dense"]
    trace = [ServeRequest(i, "ab"[i % 2], 0.0, 8, 3, 1.0) for i in range(4)]
    tenants = [Tenant(n, tm, tp, cache_len=CL, max_batch=2) for n in "ab"]
    eng = ServingEngine(tenants, mode="vliw", device="cpu")
    graphs = _stand_in(eng.jit)
    rep = eng.run(trace)
    bodies = len(_bodies(tjit.build_dense_decode_template(tm, tp, 2)))
    # the decode bodies' graphs, and one of the prompts' Model.prefill
    assert graphs.count("decode") == bodies
    assert graphs.count("monolithic") == 1
    assert rep.jit.dispatch.graph_captures == bodies
    assert rep.jit.dispatch.graph_replays > 0
    other = tm.init(torch.Generator().manual_seed(4))
    tenants = [Tenant("a", tm, tp, cache_len=CL, max_batch=2),
               Tenant("b", tm, other, cache_len=CL, max_batch=2)]
    eng = ServingEngine(tenants, mode="vliw", device="cpu")
    graphs = _stand_in(eng.jit)
    eng.run(trace)
    assert graphs.count("decode") == 2 * bodies
    assert graphs.count("monolithic") == 2


# ---------------------------------------------------------------------------
# replay against the eager body
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_replays_bitwise_equal_to_eager(models, family):
    _, _, tm, tp = models[family]
    cache, tok = _prefilled(tm, tp, 2)
    template = _builder(family)(tm, tp, 2)
    eager = tjit.VLIWJit(CostModel(TPUV5E), cuda_graphs=False)
    want = _decode(eager, template, cache, tok)
    graphed = tjit.VLIWJit(CostModel(TPUV5E))
    graphs = _stand_in(graphed)
    got = _decode(graphed, template, cache, tok)
    _assert_same(*got, *want)
    n = len(_bodies(template))
    # the bodies' graphs, and the unembed's dispatch graph beside them
    assert graphs.count("decode") == n and len(graphs) == n + 1
    st = graphed.executor.stats
    assert (st.graph_captures, st.graph_replays) == (n, 2 * n)
    assert st.graphs_by_kind()["dispatch"] == (1, 2)
    assert eager.executor.stats.graph_captures == 0
    # and the per-layer path, the bitwise oracle
    oracle = _decode(tjit.VLIWJit(CostModel(TPUV5E)),
                     _builder(family)(tm, tp, 2, stacked=False), cache, tok)
    _assert_same(*got, *oracle)


@pytest.mark.parametrize("family", FAMILIES)
def test_tenants_sharing_a_graph_keep_each_others_caches(models, family):
    _, _, tm, tp = models[family]
    cache_a, tok_a = _prefilled(tm, tp, 2, seed=3)
    cache_b, tok_b = _prefilled(tm, tp, 2, seed=4)
    template = _builder(family)(tm, tp, 2)
    jit = tjit.VLIWJit(CostModel(TPUV5E))
    graphs = _stand_in(jit)
    # a's first step captures; then a and b replay one graph in turns
    pa = template.bind(stream_id=0, tokens=tok_a, cache=cache_a)
    jit.run([pa])
    pa = template.bind(stream_id=0, tokens=tok_a, cache=pa.env["cache"])
    jit.run([pa])
    new_a = pa.env["cache"]
    kept = {k: v.clone() for k, v in new_a["layers"].items()}
    pb = template.bind(stream_id=1, tokens=tok_b, cache=cache_b)
    jit.run([pb])
    assert jit.executor.stats.graph_replays == 2 * graphs.count("decode")
    for leaf, t in new_a["layers"].items():
        assert torch.equal(t, kept[leaf]), leaf
        # a's cache is its own tensor: no static output of the graph
        for ent in graphs._entries.values():
            assert all(t.data_ptr() != s.data_ptr()
                       for s in ent.graph.static_out.values())
    eager = tjit.VLIWJit(CostModel(TPUV5E), cuda_graphs=False)
    want = template.bind(stream_id=1, tokens=tok_b, cache=cache_b)
    eager.run([want])
    assert torch.equal(pb.env["logits"], want.env["logits"])


def test_replay_adds_its_captures_launches_to_the_counters():
    """A body whose launches the wrapper counts: the capture records the
    change of one call and takes it back, each replay adds it, so the
    totals are the eager calls'."""
    shape = (8, 128, 256, 1, torch.float32)

    def body(inp, padded, ex, block=None):
        coalesced_gemm.launches += 2
        coalesced_gemm.max_groups = max(coalesced_gemm.max_groups, 3)
        by = coalesced_gemm.launches_by_shape
        by[shape] = by.get(shape, 0) + 2
        return {"x": inp["x"] * 2.0}

    st = tjit.StackedGemmStage(
        tag="body", weight_key=("m", 0, "body"), operands=[], layers=1,
        run=None, graph=BodyIO(("decode", "m", 2),
                               lambda env: {"x": env["x"]}, body))
    ex = tjit.VLIWJit().executor
    graphs = GraphCache(capture=StandIn)
    saved = (coalesced_gemm.launches, coalesced_gemm.max_groups,
             dict(coalesced_gemm.launches_by_shape))
    try:
        coalesced_gemm.launches = coalesced_gemm.max_groups = 0
        coalesced_gemm.launches_by_shape.clear()
        for step in range(3):
            env = {"x": torch.full((2, 4), float(step))}
            graphs.run(st, env, {}, ex)
            assert torch.equal(env["x"], torch.full((2, 4), 2.0 * step))
            assert coalesced_gemm.launches == 2 * (step + 1)
            assert coalesced_gemm.launches_by_shape == {
                shape: 2 * (step + 1)}
            assert coalesced_gemm.max_groups == 3
            coalesced_gemm.max_groups = 0
        assert (ex.stats.graph_captures, ex.stats.graph_replays) == (1, 2)
    finally:
        coalesced_gemm.launches, coalesced_gemm.max_groups = saved[:2]
        coalesced_gemm.launches_by_shape.clear()
        coalesced_gemm.launches_by_shape.update(saved[2])


# ---------------------------------------------------------------------------
# the weight cache's drops
# ---------------------------------------------------------------------------

def _graph_packs(graphs, kind="decode"):
    return [{tag: ref() for tag, ref in e.operands}
            for e in graphs._entries.values() if e.kind == kind]


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_eviction_and_invalidation_drop_the_graphs_reading_a_pack(
        models, family):
    _, _, tm, tp = models[family]
    cache, tok = _prefilled(tm, tp, 2)
    template = _builder(family)(tm, tp, 2)
    jit = tjit.VLIWJit(CostModel(TPUV5E))
    graphs = _stand_in(jit)
    _decode(jit, template, cache, tok, steps=2)
    n = graphs.count("decode")
    assert n == len(_bodies(template))
    wc = jit.weight_cache
    biggest = max(wc.peek(k).nbytes for k in wc.keys())
    # invalidate one pack a graph reads: that graph goes, the rest stay,
    # and the pack is freed (no graph holds it)
    pack = next(iter(_graph_packs(graphs)[0].values()))
    key = next(k for k in wc.keys() if wc.peek(k) is pack)
    ref = weakref.ref(pack)
    del pack
    wc.invalidate(key)
    assert graphs.count("decode") == n - 1 and graphs.dropped == 1
    gc.collect()
    assert ref() is None
    # a byte budget of the largest pack: the LRU churns every step, and
    # every graph left reads only packs the cache still holds
    wc.byte_capacity = biggest
    want = _decode(tjit.VLIWJit(CostModel(TPUV5E), cuda_graphs=False),
                   template, cache, tok, steps=2)
    got = _decode(jit, template, cache, tok, steps=2)
    _assert_same(*got, *want)
    assert wc.stats.evictions > 0
    held = {id(wc.peek(k)) for k in wc.keys()}
    for packs in _graph_packs(graphs):
        assert all(id(p) in held for p in packs.values())
    wc.clear()
    assert len(graphs) == 0


def test_hot_swap_drops_the_old_graphs_and_serves_the_new_weights(models):
    _, _, tm, p_old = models["moe"]
    p_new = tm.init(torch.Generator().manual_seed(77))
    trace1 = [ServeRequest(0, "a", 0.0, 8, 3, 1.0)]
    trace2 = [ServeRequest(1, "a", 0.0, 8, 3, 1.0)]
    eng = ServingEngine([Tenant("a", tm, p_old, cache_len=CL, max_batch=2)],
                        mode="vliw", device="cpu")
    graphs = _stand_in(eng.jit)
    eng.run(trace1)
    old = _graph_packs(graphs)
    assert len(old) == 1
    old_refs = [weakref.ref(p) for p in old[0].values()]
    del old
    eng.tenants["a"].params = p_new          # weight hot-swap, same model
    swapped = eng.run(trace2)
    assert eng.jit.executor.stats.weight_invalidations >= 1
    assert graphs.dropped >= 1 and graphs.count("decode") == 1
    # the old packs are freed: neither the cache nor a graph holds them
    gc.collect()
    assert all(r() is None for r in old_refs)
    held = {id(wc_p) for wc_p in (eng.jit.weight_cache.peek(k)
                                   for k in eng.jit.weight_cache.keys())}
    assert all(id(p) in held for p in _graph_packs(graphs)[0].values())
    fresh = ServingEngine([Tenant("a", tm, p_new, cache_len=CL,
                                  max_batch=2)],
                          mode="vliw", device="cpu",
                          cuda_graphs=False).run(trace2)
    assert {r.req_id: r.tokens_out for r in swapped.requests} == \
        {r.req_id: r.tokens_out for r in fresh.requests}


# ---------------------------------------------------------------------------
# the CPU path
# ---------------------------------------------------------------------------

def test_cpu_never_captures_and_tokens_stay_the_references(models):
    names = [f"t{i}:{f}" for i, f in enumerate(FAMILIES)]
    trace = sorted((ServeRequest(i, names[i % 3], 1e-4 * i, 8, 3, 1.0)
                    for i in range(6)), key=lambda r: r.arrival_t)

    def prompt(cfg, req, rng=jax.random.PRNGKey(0)):
        return np.array(jax.random.randint(
            jax.random.fold_in(rng, req.req_id), (1, req.prompt_len), 0,
            cfg.vocab_size))

    jrep = JaxEngine([JaxTenant(n, models[f][0], models[f][1], cache_len=CL,
                                max_batch=2)
                      for n, f in zip(names, FAMILIES)],
                     mode="vliw", cost=JaxCostModel(JTPU)).run(trace)
    eng = ServingEngine(
        [Tenant(n, models[f][2], models[f][3], cache_len=CL, max_batch=2)
         for n, f in zip(names, FAMILIES)],
        mode="vliw", cost=CostModel(TPUV5E), device="cpu",
        prompt_fn=lambda t, r: torch.from_numpy(prompt(t.cfg, r)))
    assert eng.jit.cuda_graphs
    trep = eng.run(trace)
    assert trep.jit.dispatch.graph_captures == 0
    assert trep.jit.dispatch.graph_replays == 0 and len(eng.jit.graphs) == 0
    got = {r.req_id: list(r.tokens_out) for r in trep.requests}
    assert got == {r.req_id: list(r.tokens_out) for r in jrep.requests}
    assert all(len(v) == 3 for v in got.values())


# ---------------------------------------------------------------------------
# the fixed-shape MoE dispatch
# ---------------------------------------------------------------------------

def _masked_dispatch(x, weights, experts, E, k, C):
    """The dispatch this port shipped before: ``bincount`` counts and a
    masked ``index_put_`` (shapes that depend on the routing)."""
    T, d = x.shape
    e_flat = experts.reshape(-1)
    tok_of = torch.arange(T * k) // k
    order = torch.argsort(e_flat, stable=True)
    sorted_e, sorted_tok = e_flat[order], tok_of[order]
    counts = torch.bincount(sorted_e, minlength=E)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1]])
    rank = torch.arange(T * k) - offsets[sorted_e]
    keep = rank < C
    slot = torch.where(keep, rank, torch.full_like(rank, C))
    buf = torch.zeros((E, C, d), dtype=x.dtype)
    buf.index_put_((sorted_e[keep], slot[keep]),
                   x.index_select(0, sorted_tok[keep]))
    return buf, (order, sorted_e, sorted_tok, keep, slot)


@pytest.mark.parametrize("E,k,T,cf", [(2, 2, 8, 1.25), (4, 2, 12, 0.5),
                                      (8, 2, 4, 0.25), (4, 1, 13, 0.25)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fixed_shape_dispatch_bitwise_equal_to_masked(E, k, T, cf, dtype):
    cfg = MoEConfig(num_experts=E, top_k=k, capacity_factor=cf)
    C = tmoe.capacity(T, cfg)
    rng = np.random.default_rng(E * 100 + T)
    drops = 0
    for trial in range(8):
        x = torch.from_numpy(rng.standard_normal((T, 16)).astype(
            np.float32)).to(dtype)
        router = torch.from_numpy(rng.standard_normal((16, E)).astype(
            np.float32))
        w, e, _ = tmoe.route(router, x, cfg)
        got, gmeta = tmoe.dispatch_tokens(x, w, e, E, k, C)
        want, wmeta = _masked_dispatch(x, w, e, E, k, C)
        assert got.shape == want.shape == (E, C, 16)
        assert torch.equal(got, want)
        assert all(torch.equal(a, b) for a, b in zip(gmeta, wmeta))
        drops += int((~wmeta[3]).sum())
        out = torch.from_numpy(rng.standard_normal((E, C, 16)).astype(
            np.float32)).to(dtype)
        assert torch.equal(
            tmoe.combine_tokens(out, w.reshape(-1), gmeta, T, 16),
            tmoe.combine_tokens(out, w.reshape(-1), wmeta, T, 16))
    if cf < 1.0:
        assert drops > 0                     # capacity drops exercised


@pytest.mark.parametrize("E,k,T,cf", [(4, 2, 12, 0.5), (8, 2, 16, 0.25)])
def test_fixed_shape_dispatch_matches_reference(E, k, T, cf):
    jcfg = JaxMoEConfig(num_experts=E, top_k=k, capacity_factor=cf)
    tcfg = MoEConfig(num_experts=E, top_k=k, capacity_factor=cf)
    jp = jmoe.init_moe(jax.random.PRNGKey(E), 32, 64, jcfg, jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    x = np.random.default_rng(T).standard_normal((T, 32)).astype(np.float32)
    C = tmoe.capacity(T, tcfg)
    jw, je, _ = jmoe.route(jp["router"], jnp.asarray(x), jcfg)
    tw, te, _ = tmoe.route(tp["router"], torch.from_numpy(x), tcfg)
    jbuf, jmeta = jmoe.dispatch_tokens(jnp.asarray(x), jw, je, E, k, C)
    tbuf, tmeta = tmoe.dispatch_tokens(torch.from_numpy(x), tw, te, E, k, C)
    assert not tmeta[3].numpy().all()        # drops
    for got, want in zip(tmeta, jmeta):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    out = np.random.default_rng(3).standard_normal((E, C, 32)).astype(
        np.float32)
    jy = jmoe.combine_tokens(jnp.asarray(out), jw.reshape(-1), jmeta, T, 32)
    ty = tmoe.combine_tokens(torch.from_numpy(out), tw.reshape(-1), tmeta,
                             T, 32)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# q·kᵀ with an fp32 result
# ---------------------------------------------------------------------------

SCORE_SHAPES = [  # (B, s, Hkv, G, hd, T): decode, prefill, a GQA chunk
    (4, 1, 2, 4, 64, 40), (1, 16, 2, 2, 32, 16), (2, 8, 1, 4, 128, 24)]


def _qk(shape, k_heads_first, seed):
    B, s, H, G, hd, T = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, s, H, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, H, T, hd) if k_heads_first
                            else (B, T, H, hd)).astype(np.float32)
    return q, k


@pytest.mark.parametrize("k_heads_first", [False, True])
@pytest.mark.parametrize("shape", SCORE_SHAPES)
def test_bf16_scores_match_reference_einsum(shape, k_heads_first):
    """Both routes of a bf16 product (the card's one batched product, run
    here with a widened forward, and the CPU's widened einsum) against the
    JAX package's ``preferred_element_type=float32`` einsum, within the
    bf16 tolerance of tests/test_kernels.py."""
    q, k = _qk(shape, k_heads_first, seed=sum(shape))
    eq = "bshgd,bhtd->bhgst" if k_heads_first else "bshgd,bthd->bhgst"
    want = np.asarray(jnp.einsum(eq, jnp.asarray(q, jnp.bfloat16),
                                 jnp.asarray(k, jnp.bfloat16),
                                 preferred_element_type=jnp.float32))
    tq, tk = (torch.from_numpy(a).bfloat16() for a in (q, k))
    for got in (qk_scores(tq, tk, k_heads_first=k_heads_first),
                _bmm_scores(tq, tk, k_heads_first)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=8e-2,
                                   atol=8e-2 * 8)


@pytest.mark.parametrize("k_heads_first", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_and_fp32_scores_keep_the_widened_einsum(dtype, k_heads_first):
    """On the CPU, and in fp32 anywhere, the product is the fp32 einsum of
    the widened operands it was before: bitwise, forward and backward."""
    q, k = _qk(SCORE_SHAPES[0], k_heads_first, seed=7)
    eq = "bshgd,bhtd->bhgst" if k_heads_first else "bshgd,bthd->bhgst"
    tq, tk = (torch.from_numpy(a).to(dtype).requires_grad_()
              for a in (q, k))
    got = qk_scores(tq, tk, k_heads_first=k_heads_first)
    want = torch.einsum(eq, tq.float(), tk.float())
    assert torch.equal(got, want)
    g = torch.randn_like(got)
    assert all(torch.equal(a, b) for a, b in zip(
        torch.autograd.grad(got, (tq, tk), g),
        torch.autograd.grad(want, (tq, tk), g)))


@pytest.mark.parametrize("k_heads_first", [False, True])
@pytest.mark.parametrize("shape", SCORE_SHAPES)
def test_bf16_route_backward_is_the_widened_gradient(shape, k_heads_first):
    """The card route's backward: the fp32 cotangent times the other
    operand widened, rounded to bf16 (the JAX package's transpose rule),
    held against autograd of the widened einsum; both sum in fp32 in other
    orders, so each gradient within one bf16 ulp."""
    q, k = _qk(shape, k_heads_first, seed=11)
    eq = "bshgd,bhtd->bhgst" if k_heads_first else "bshgd,bthd->bhgst"
    tq, tk = (torch.from_numpy(a).bfloat16().requires_grad_()
              for a in (q, k))
    got = _bmm_scores(tq, tk, k_heads_first)
    want = torch.einsum(eq, tq.float(), tk.float())
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        tuple(got.shape)).astype(np.float32))
    for a, b in zip(torch.autograd.grad(got, (tq, tk), g),
                    torch.autograd.grad(want, (tq, tk), g)):
        assert a.dtype == b.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b.float(), rtol=2 ** -7,
                                   atol=1e-5)
