"""The executor's dispatch bodies as CUDA graphs (``repro_torch/core/
dispatch.py``, kind ``"dispatch"`` of ``repro_torch/core/graphs.py``), on
the CPU.

The JAX package ``jax.jit``s ``_dispatch_grouped``, ``_dispatch_shared``
and ``_dispatch_matvec``; the port replays each as a CUDA graph on the
card. A CPU has no CUDA graph, so the cache is driven with a stand-in
capture (``StandIn``, as in tests/test_torch_graphs.py): its "capture" runs
the captured launch once on the static packed buffer, its replay runs it
again into the static output. Everything around the graph is the code the
card runs: the key, the copy-in into views of the packed buffer, the
copy-out, the weight cache's drops and the kernel counters.

  * The key: the body and its static arguments (``n_real``, ``m_tiles``,
    ``bm``), the activations' shapes, and the pack's identity.
  * Grouped, shared and matvec replays bitwise equal to the eager bodies
    (values and strides) at G = 1, 2, 3, 8, ragged rows, a tuned bm.
  * A replay adds its capture's launches to the kernel counters; two
    calls of one key do not alias.
  * Eviction, invalidation and a hot-swap drop the graphs that read a
    pack; a pack the cache cannot hold runs eagerly.
  * The real cache on the CPU captures nothing.
  * A second run over warm templates captures no dispatch graph (the
    JAX package's "not one retrace", tests/test_dispatch.py).
  * The executor's outputs equal the JAX package's ``SuperkernelExecutor``
    (fp32, 2e-4).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dispatch import SuperkernelExecutor as JaxExecutor
from repro_torch.configs import smoke_config
from repro_torch.core import jit as tjit
from repro_torch.core import dispatch as tdispatch
from repro_torch.core.costmodel import BlockConfig, CostModel, TPUV5E
from repro_torch.core.dispatch import SuperkernelExecutor
from repro_torch.core.graphs import GraphCache, _counters, _restore
from repro_torch.core.plancache import PlanCache
from repro_torch.kernels.coalesced_gemm import coalesced_gemm
from repro_torch.kernels.coalesced_gemv import coalesced_gemv
from repro_torch.models import Model

GiB = 1 << 30


class StandIn:
    """A CPU stand-in for one captured launch: like a graph, its replay
    calls no kernel wrapper and leaves the launch counters as they were."""

    def __init__(self, fn, static_in, stream, pool):
        self.fn, self.static_in = fn, static_in
        self.static_out = fn(static_in)

    def replay(self):
        counts = _counters()
        for name, t in self.fn(self.static_in).items():
            self.static_out[name].copy_(t)
        _restore(counts)


def _stand_in(ex):
    """Give ``ex`` (an executor, or a VLIWJit's, whose cache is the JIT's)
    a graph cache whose captures are stand-ins, wired to the weight cache
    as the real one is."""
    ex.weight_cache.on_drop.remove(ex.graphs.drop_operand)
    ex.graphs = GraphCache(capture=StandIn, resident=ex.weight_cache.holds)
    ex.weight_cache.on_drop.append(ex.graphs.drop_operand)
    return ex.graphs


def _executors(budget=GiB, capacity=64):
    """(eager executor, graphed executor on stand-in captures)."""
    eager = SuperkernelExecutor(PlanCache(capacity, byte_capacity=budget),
                                cuda_graphs=False)
    graphed = SuperkernelExecutor(PlanCache(capacity, byte_capacity=budget))
    _stand_in(graphed)
    return eager, graphed


def _rows(G):
    """Ragged rows a member: 1, 5, 3, 7, 2, ..."""
    return [1 + (4 * i) % 7 for i in range(G)]


def _weights(rng, G, shared, K=200, N=300, ragged=True):
    """Weights of G members, K and N ragged across members below the
    (256, 384) envelope (``ragged``, else one shape); one tensor G times
    when shared."""
    if shared:
        return [torch.from_numpy(rng.standard_normal((K, N))
                                 .astype(np.float32))] * G
    step = 1 if ragged else 0
    return [torch.from_numpy(rng.standard_normal(
        (K - 7 * i * step, N - 11 * i * step)).astype(np.float32)
        / np.sqrt(K)) for i in range(G)]


def _acts(rng, ws, rows):
    return [torch.from_numpy(rng.standard_normal((m, int(w.shape[0])))
                             .astype(np.float32))
            for m, w in zip(rows, ws)]


def _wkeys(ws):
    return [("m", id(w), "w") for w in ws]


def _call(ex, body, acts, ws, block=None, group=None):
    if body.startswith("matvec"):
        return ex.matvec([a[0] for a in acts], ws, group=group)
    return ex.execute_problems(list(zip(acts, ws)), _wkeys(ws),
                               shared_operand=body == "shared",
                               block=block, group=group)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
        assert g.shape == w.shape and g.stride() == w.stride()


# ---------------------------------------------------------------------------
# the key
# ---------------------------------------------------------------------------

def test_key_is_static_args_shapes_and_pack():
    rng = np.random.default_rng(0)
    _, ex = _executors()
    graphs = ex.graphs
    ws = _weights(rng, 2, False)
    rows = [3, 5]
    for _ in range(3):               # one key: a capture, then replays
        _call(ex, "grouped", _acts(rng, ws, rows), ws)
    assert ex.stats.graphs_by_kind()["dispatch"] == (1, 2)
    # the head: the body and its static arguments, as the JAX package
    # keys its jit (n_real, m_tiles, bm)
    assert graphs.heads("dispatch") == {
        ("grouped", (ws[0].shape[1], ws[1].shape[1]), 2, 8)}
    (ent,) = graphs._entries.values()
    assert {tag for tag, _ in ent.operands} == {"b", "gids"}
    # other rows within the same tiles: another signature, another key
    _call(ex, "grouped", _acts(rng, ws, [2, 5]), ws)
    # a tuned bm: another head
    _call(ex, "grouped", _acts(rng, ws, rows), ws,
          block=BlockConfig(bm=16, bn=128, bk=512))
    # another weight set of the same shapes: another pack, another key
    ws2 = [w.clone() for w in ws]
    _call(ex, "grouped", _acts(rng, ws2, rows), ws2)
    assert len(graphs) == 4 and ex.stats.dispatch_graph_captures == 4
    heads = graphs.heads("dispatch")
    assert ("grouped", (ws[0].shape[1], ws[1].shape[1]), 2, 16) in heads
    assert len(heads) == 2          # the signature and pack are not heads
    # shared and matvec heads
    sw = _weights(rng, 3, True)
    _call(ex, "shared", _acts(rng, sw, [1, 2, 4]), sw)
    mw = _weights(rng, 3, False)
    _call(ex, "matvec", _acts(rng, mw, [1, 1, 1]), mw)
    heads = graphs.heads("dispatch")
    assert ("shared", 300, 1, 8) in heads
    assert ("matvec", (300, 289, 278, 300)) in heads


# ---------------------------------------------------------------------------
# replay against the eager body
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("body,G,bm", [
    (body, G, bm) for body in ("grouped", "shared", "matvec", "matvec-one-k")
    for G in (1, 2, 3, 8)
    for bm in ((None,) if body.startswith("matvec") else (None, 32))])
def test_replays_bitwise_equal_to_eager(body, G, bm):
    """(The matvec body has no m-tile; "matvec-one-k": vectors and
    weights of one shape.)"""
    rng = np.random.default_rng(G)
    eager, graphed = _executors()
    ws = _weights(rng, G, body == "shared", ragged=body != "matvec-one-k")
    rows = [1] * G if body.startswith("matvec") else _rows(G)
    block = None if bm is None else BlockConfig(bm=bm, bn=128, bk=512)
    for _ in range(3):
        acts = _acts(rng, ws, rows)
        _same(_call(graphed, body, acts, ws, block),
              _call(eager, body, acts, ws, block))
    # matvec over one weight tensor is the shared GEMM path
    assert graphed.stats.graphs_by_kind()["dispatch"] == (1, 2)
    assert eager.stats.graphs_by_kind()["dispatch"] == (0, 0)
    assert graphed.stats.dispatches == eager.stats.dispatches == 3
    (ent,) = graphed.graphs._entries.values()
    bm_used = 8 if bm is None else bm
    if not body.startswith("matvec"):
        assert ent.head[-1] == bm_used


def test_replay_adds_its_captures_launches_to_the_counters(monkeypatch):
    """The plain versions count nothing on the CPU; a counting stand-in for
    each wrapper shows that a capture takes its launch back and every
    replay adds it, so the totals equal the eager run's."""
    real_gemm, real_gemv = coalesced_gemm, coalesced_gemv

    def gemm(a, b, gids, *, bm):
        real_gemm.launches += 1
        real_gemm.max_groups = max(real_gemm.max_groups, int(b.shape[0]))
        key = (int(a.shape[0]), int(a.shape[1]), int(b.shape[2]),
               int(b.shape[0]), a.dtype)
        real_gemm.launches_by_shape[key] = \
            real_gemm.launches_by_shape.get(key, 0) + 1
        real_gemm.launches_by_bm[bm] = real_gemm.launches_by_bm.get(bm, 0) + 1
        return real_gemm(a, b, gids, bm=bm)

    def gemv(x, w):
        real_gemv.launches += 1
        return real_gemv(x, w)

    monkeypatch.setattr(tdispatch, "coalesced_gemm", gemm)
    monkeypatch.setattr(tdispatch, "coalesced_gemv", gemv)
    saved = _counters()
    try:
        rng = np.random.default_rng(3)
        ws, mw = _weights(rng, 3, False), _weights(rng, 4, False)
        counts = {}
        for label, ex in zip(("eager", "graphed"), _executors()):
            for (fn, name), v in _counters().items():
                if isinstance(v, dict):
                    getattr(fn, name).clear()
                else:
                    setattr(fn, name, 0)
            for _ in range(3):
                _call(ex, "grouped", _acts(rng, ws, [2, 9, 4]), ws)
                _call(ex, "matvec", _acts(rng, mw, [1] * 4), mw)
            counts[label] = _counters()
        assert counts["graphed"] == counts["eager"]
        assert real_gemm.launches == real_gemv.launches == 3
        assert real_gemm.launches_by_bm == {8: 3}
        assert real_gemm.max_groups == 4
    finally:
        _restore(saved)


def test_two_calls_of_one_key_do_not_alias():
    """A replay's outputs are its own tensors: the next replay of the key
    (another tenant's, say) leaves them as they were."""
    rng = np.random.default_rng(4)
    eager, ex = _executors()
    ws = _weights(rng, 2, False)
    calls = [_acts(rng, ws, [3, 4]) for _ in range(3)]
    outs = [_call(ex, "grouped", acts, ws) for acts in calls]
    (ent,) = ex.graphs._entries.values()
    static = ent.graph.static_out["out"].untyped_storage().data_ptr()
    for acts, out in zip(calls, outs):     # after every later replay
        _same(out, _call(eager, "grouped", acts, ws))
        assert all(o.untyped_storage().data_ptr() != static for o in out)
    assert outs[1][0].untyped_storage().data_ptr() != \
        outs[2][0].untyped_storage().data_ptr()


# ---------------------------------------------------------------------------
# the weight cache's drops
# ---------------------------------------------------------------------------

def test_eviction_invalidation_and_hot_swap_drop_the_graphs():
    rng = np.random.default_rng(5)
    w = [_weights(rng, 2, False) for _ in range(3)]
    eager, ex = _executors()
    _call(ex, "grouped", _acts(rng, w[0], [2, 3]), w[0])
    pack = ex.weight_cache.bytes
    # a budget of two packs: the third evicts the first, and its graph
    ex.weight_cache.byte_capacity = 2 * pack
    for ws in w[1:]:
        _call(ex, "grouped", _acts(rng, ws, [2, 3]), ws)
    assert len(ex.graphs) == 2 and ex.graphs.dropped == 1
    assert ex.weight_cache.stats.evictions == 1
    # invalidation: the cache drops a pack, the graph that read it goes
    key = next(k for k in ex.weight_cache.keys())
    ex.weight_cache.invalidate(key)
    assert len(ex.graphs) == 1 and ex.graphs.dropped == 2
    # a hot-swap of one dispatch slot (a stable group, new tensors): the
    # old pack is invalidated, its graph dropped, the new weights served
    _, ex = _executors()
    old = _weights(rng, 2, False)
    acts = _acts(rng, old, [2, 3])
    _call(ex, "grouped", acts, old, group="slot")
    _call(ex, "grouped", acts, old, group="slot")
    new = [x * 2.0 for x in old]
    got = _call(ex, "grouped", acts, new, group="slot")
    assert ex.stats.weight_invalidations == 1 and ex.graphs.dropped == 1
    assert len(ex.graphs) == 1
    _same(got, _call(eager, "grouped", acts, new))
    # a pack larger than the whole budget is not held: eager, no graph
    _, small = _executors(budget=pack // 2)
    for _ in range(2):
        got = _call(small, "grouped", acts, new)
    assert len(small.graphs) == 0
    assert small.stats.graphs_by_kind()["dispatch"] == (0, 0)
    _same(got, _call(eager, "grouped", acts, new))


def test_real_cache_on_the_cpu_captures_nothing():
    rng = np.random.default_rng(6)
    eager = SuperkernelExecutor(cuda_graphs=False)
    ex = SuperkernelExecutor()            # its own real cache
    assert ex.cuda_graphs and ex.graphs.drop_operand in \
        ex.weight_cache.on_drop
    for body, G in (("grouped", 3), ("shared", 2), ("matvec", 4)):
        ws = _weights(rng, G, body == "shared")
        rows = [1] * G if body == "matvec" else _rows(G)
        for _ in range(2):
            acts = _acts(rng, ws, rows)
            _same(_call(ex, body, acts, ws), _call(eager, body, acts, ws))
    assert len(ex.graphs) == 0
    assert ex.stats.graphs_by_kind()["dispatch"] == (0, 0)
    # a VLIWJit hands its executor its own cache and flag
    vj = tjit.VLIWJit(CostModel(TPUV5E))
    assert vj.executor.graphs is vj.graphs and vj.executor.cuda_graphs
    vj.cuda_graphs = False
    assert not vj.executor.cuda_graphs


# ---------------------------------------------------------------------------
# steady state and the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stacked", [False, True])
def test_steady_state_ticks_zero_dispatch_captures(stacked):
    """The counterpart of tests/test_dispatch.py's acceptance assertion:
    after a warm-up run, a second run over rebound programs of the same
    shapes captures not one dispatch graph (each dispatch a replay), packs
    nothing and builds no kernel; logits equal the eager JIT's bit for
    bit."""
    cfg = smoke_config("gemma3-1b")
    m = Model(cfg, param_dtype=torch.float32, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12)))
    _, cache = m.prefill(params, {"tokens": toks}, cache_len=32)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1)))
    template = tjit.build_dense_decode_template(m, params, 2,
                                                stacked=stacked)

    def progs():
        return [template.bind(stream_id=i, tokens=tok, cache=cache)
                for i in range(3)]

    jit = tjit.VLIWJit(CostModel(TPUV5E), max_group=8)
    _stand_in(jit.executor)
    warm = jit.run(progs())
    assert warm.dispatch.dispatch_graph_captures > 0
    assert warm.dispatch.weight_misses > 0
    got = progs()
    steady = jit.run(got)
    assert steady.dispatch.dispatch_graph_captures == 0
    assert steady.dispatch.dispatch_graph_replays > 0
    assert steady.dispatch.retraces == 0
    assert steady.dispatch.weight_misses == 0
    assert steady.dispatch.weight_hit_rate == 1.0
    eager = tjit.VLIWJit(CostModel(TPUV5E), max_group=8, cuda_graphs=False)
    want = progs()
    eager.run(want)
    for g, w in zip(got, want):
        assert torch.equal(g.env["logits"], w.env["logits"])


def test_executor_matches_the_reference_executor():
    """Grouped (G = 3, ragged), shared (G = 2) and matvec (G = 3, distinct
    weights) dispatches, replayed, against the JAX package's executor on
    the same inputs (its Pallas kernels in interpret mode), fp32 2e-4."""
    rng = np.random.default_rng(8)
    _, ex = _executors()
    ref = JaxExecutor(bm=8, interpret=True)
    for body, G in (("grouped", 3), ("shared", 2), ("matvec", 3)):
        ws = _weights(rng, G, body == "shared")
        rows = [1] * G if body == "matvec" else _rows(G)
        jws = [jnp.asarray(w.numpy()) for w in ws]
        if body == "shared":
            jws = [jws[0]] * G
        for _ in range(2):                      # a capture, then a replay
            acts = _acts(rng, ws, rows)
            got = _call(ex, body, acts, ws)
        jacts = [jnp.asarray(a.numpy()) for a in acts]
        if body == "matvec":
            want = ref.matvec([a[0] for a in jacts], jws)
        else:
            want = ref.execute_problems(
                list(zip(jacts, jws)), [("m", i) for i in range(G)]
                if body == "grouped" else [("m", 0)] * G,
                shared_operand=body == "shared")
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=2e-4, atol=2e-4)
    assert ex.stats.graphs_by_kind()["dispatch"] == (3, 3)
