"""The port's SPMD layer against the JAX package's, on the CPU.

  * ``_spec_for`` equals the reference's ``PartitionSpec`` for every leaf
    of every architecture on both production meshes (the reference test's
    ``FakeMesh``); batch and cache shardings equal the reference's for
    every supported (architecture, input shape, mesh);
  * ``to_placements`` on a real world-1 ``DeviceMesh`` (gloo on a
    ``FileStore`` in the test's directory, no TCP, each such test under a
    time limit of its own); ``constrain`` is a no-op outside its context
    and redistributes a DTensor inside it;
  * one production train step (DTensor params and optimizer state, each
    weight gathered at use, a layer's inside its body) is bitwise equal
    to the plain step, and issues no collective;
  * the MoE token exchange: ``moe_ffn`` on D ranks (threads meeting at a
    barrier, no process group), each with its block of the tokens and of
    the experts, equals one process under ``moe_groups = D``;
  * the dry-run's per-chip param and optimizer bytes equal the sums of
    shard sizes from the reference's specs; ``model_flops_for`` equals the
    reference's and the roofline uses the H100's spec-sheet rates.
"""
import math
import signal
import threading
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_sharding_rules import FakeMesh, _specs

from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.distributed import sharding as jsh
from repro.launch import hlo_analysis as jhlo
from repro.models import Model as JaxModel
from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, get_config,
                                 pair_is_supported, smoke_config)
from repro_torch.core import H100
from repro_torch.distributed import hints
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import Model
from repro_torch.training import (DataConfig, OptimizerConfig, SyntheticLM,
                                  batch_to_device, init_opt_state,
                                  make_train_step)
from repro_torch.tree import flatten_with_path, leaves, path_key, tree_map

PG_LIMIT_S = 60


def _meta_model(arch):
    return Model(get_config(arch), param_dtype=torch.bfloat16,
                 device="meta")


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_for_equals_reference(arch, multi):
    want = _specs(arch, multi)
    mesh = FakeMesh(multi)
    got = {path_key(p): (tsh._spec_for(path_key(p), tuple(t.shape), mesh),
                         tuple(t.shape))
           for p, t in flatten_with_path(_meta_model(arch).abstract_params())}
    assert sorted(got) == sorted(want)
    for key, (spec, shape) in want.items():
        assert got[key][1] == tuple(shape), key
        assert got[key][0] == tuple(spec), (key, got[key][0], spec)


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_shardings_equal_reference(arch, multi, monkeypatch):
    # the reference wraps each spec in a NamedSharding, which needs a real
    # mesh; read the bare specs instead
    monkeypatch.setattr(jsh, "_named", lambda mesh, spec: tuple(spec))
    mesh = FakeMesh(multi)
    jm = JaxModel(jax_get_config(arch), param_dtype=jnp.bfloat16)
    tm = _meta_model(arch)
    n = 0
    for name in INPUT_SHAPES:
        if not pair_is_supported(arch, name):
            continue
        want = jsh.batch_shardings(jm, JAX_SHAPES[name], mesh)
        got = tsh.batch_shardings(tm, INPUT_SHAPES[name], mesh)
        jflat = jax.tree_util.tree_flatten_with_path(
            want, is_leaf=lambda x: isinstance(x, tuple))[0]
        tflat = list(flatten_with_path(got))
        assert len(jflat) == len(tflat), name
        for (jp, a), (tp, b) in zip(jflat, tflat):
            assert b.spec == a, (name, path_key(tp), b.spec, a)
            n += 1
    assert n > 0


@pytest.fixture
def world1(tmp_path):
    """A world-1 gloo process group on a FileStore, under a time limit."""
    main = threading.current_thread() is threading.main_thread()

    def over(*_):
        raise TimeoutError(f"process-group test over {PG_LIMIT_S} s")

    if main:
        old = signal.signal(signal.SIGALRM, over)
        signal.alarm(PG_LIMIT_S)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=timedelta(seconds=PG_LIMIT_S))
    try:
        yield
    finally:
        dist.destroy_process_group()
        if main:
            signal.alarm(0)
            signal.signal(signal.SIGALRM, old)


def test_meshes(world1):
    single, multi = (make_production_mesh(multi_pod=m) for m in (False, True))
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512
    host = make_host_mesh("cpu")
    assert tuple(host.shape) == (1, 1)
    assert host.mesh_dim_names == ("data", "model")
    assert tsh.axis_sizes(make_host_mesh("cpu", multi_pod=True)) == {
        "pod": 1, "data": 1, "model": 1}


def test_to_placements(world1):
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_host_mesh("cpu")
    assert tsh.to_placements(("data", None), mesh) == [Shard(0), Replicate()]
    assert tsh.to_placements((None, None, "model"), mesh) == [
        Replicate(), Shard(2)]
    assert tsh.to_placements((("data",), "model"), mesh) == [Shard(0),
                                                             Shard(1)]
    assert tsh.to_placements((), mesh) == [Replicate(), Replicate()]
    pod = make_host_mesh("cpu", multi_pod=True)
    assert tsh.to_placements((("pod", "data"), None, "model"), pod) == [
        Shard(0), Shard(0), Shard(2)]


def test_constrain_is_a_noop_outside_its_context(world1):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    x = torch.randn(4, 6, 8)
    assert hints.constrain(x, "btd") is x
    assert hints.static_hint("moe_groups", 1) == 1
    mesh = make_host_mesh("cpu")
    d = distribute_tensor(x, mesh, [Replicate(), Replicate()])
    assert hints.constrain(d, "btd") is d
    spec = {"btd": tsh.NamedSharding(mesh, (("data",), None, None)),
            "moe_groups": 3}
    with hints.activation_sharding(spec):
        assert hints.constrain(x, "btd") is x      # a plain tensor
        assert hints.constrain(d, "other") is d
        out = hints.constrain(d, "btd")
        assert tuple(out.placements) == (Shard(0), Replicate())
        assert torch.equal(out.full_tensor(), x)
        assert hints.static_hint("moe_groups", 1) == 3
        with hints.activation_sharding({}):
            assert hints.static_hint("moe_groups", 1) == 1
        assert hints.static_hint("moe_groups", 1) == 3
    assert hints.static_hint("moe_groups", 1) == 1


@pytest.mark.parametrize("arch", ["gemma3-1b", "grok-1-314b",
                                  "llama4-maverick-400b-a17b"])
def test_production_step_equals_plain_step(arch, world1):
    """DTensor params and optimizer state placed by the rules on the host
    mesh, each weight gathered at use (a layer's inside its body): one
    step bitwise equal to the plain step from the same params and batch,
    and no collective issued (``step_cost``'s counter)."""
    from repro_torch.launch.mesh import production_state
    from repro_torch.launch.step_cost import count_step
    cfg = smoke_config(arch)
    model = Model(cfg, param_dtype=torch.float32, device="cpu")
    batch = batch_to_device(next(iter(SyntheticLM(
        cfg, DataConfig(batch_size=2, seq_len=32, seed=2)))), model)
    params = model.init(torch.Generator().manual_seed(3))
    plain = tree_map(torch.clone, params)
    step = make_train_step(model, OptimizerConfig(lr=1e-3, warmup_steps=1,
                                                  total_steps=4))
    p1, s1, m1 = step(plain, init_opt_state(plain), batch)
    mesh = make_host_mesh("cpu")
    dparams, dopt, hint = production_state(model, params, mesh, 2)
    want = tsh.param_shardings(model, mesh)
    for t, s in zip(leaves(dparams), leaves(want)):
        assert list(t.placements) == s.placements
    for t, s in zip(leaves(dopt.mu), leaves(want)):
        assert list(t.placements) == s.placements and t.dtype == torch.float32
    with hints.activation_sharding(hint):
        (p2, s2, m2), totals, _ = count_step(step, dparams, dopt, batch)
    assert totals.collective_bytes == 0, totals.per_collective
    assert float(m2["loss"]) == float(m1["loss"])
    assert float(m2["grad_norm"]) == float(m1["grad_norm"])
    for a, b in zip(leaves(p1), leaves(p2)):
        assert torch.equal(a, b.full_tensor())
    for a, b in zip(leaves(s1.nu), leaves(s2.nu)):
        assert torch.equal(a, b.full_tensor())


class _ThreadGroup:
    """``n`` threads standing in for the ranks of one process group (no
    process group at all): each collective waits at a barrier for every
    rank's operand."""

    def __init__(self, n):
        self.n = n
        self.barrier = threading.Barrier(n, timeout=PG_LIMIT_S)
        self.slots = [None] * n

    def gather(self, rank, value):
        self.slots[rank] = value
        self.barrier.wait()
        got = list(self.slots)
        self.barrier.wait()
        return got


class _ThreadMesh:
    """A one-axis ("data") mesh as rank ``rank`` of a ``_ThreadGroup``
    sees it; its group handle is (the group, the rank)."""
    mesh_dim_names = ("data",)

    def __init__(self, group, rank):
        self.shape = (group.n,)
        self.handle = (group, rank)

    def get_group(self, axis):
        return self.handle

    def get_local_rank(self, axis):
        return self.handle[1]


def _thread_all_reduce(t, handle, op=None):
    group, rank = handle
    return torch.stack(group.gather(rank, t.clone())).sum(0)


def _thread_all_to_all(t, handle):
    group, rank = handle
    got = group.gather(rank, t.contiguous().chunk(group.n))
    return torch.cat([got[i][rank] for i in range(group.n)])


class _ThreadAllReduce(torch.autograd.Function):
    """``torch.distributed.nn``'s all-reduce over a ``_ThreadGroup``: the
    sum forward, and the sum of the outputs' gradients backward."""

    @staticmethod
    def forward(ctx, x, handle):
        ctx.handle = handle
        return _thread_all_reduce(x, handle)

    @staticmethod
    def backward(ctx, g):
        return _thread_all_reduce(g, ctx.handle), None


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("arch", ["grok-1-314b", "llama4-maverick-400b-a17b"])
def test_expert_exchange_equals_one_process(arch, D, monkeypatch):
    """``moe_ffn`` on D ranks, each holding its block of the tokens and
    of the experts and trading tokens by ``exchange_experts``, against one
    process's ``moe_ffn`` under ``moe_groups = D`` on the same tokens
    (fp32): the outputs exact, the aux loss and every gradient within
    1e-6 — a rank's expert gradient is its block of the whole one (the
    exchange's backward returns each rank's slots to it), its token
    gradient its rows, and the router's gradients sum to the whole. The
    ranks are threads and the collectives meet at a barrier
    (``_ThreadGroup``), so no process group is started."""
    from repro_torch.models.moe import moe_ffn
    cfg = smoke_config(arch).moe
    E, d, ff, T = cfg.num_experts, 32, 48, 24 * D
    rng = np.random.default_rng(7)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32) * 0.3)

    params = {"router": draw(d, E), "w_gate": draw(E, d, ff),
              "w_up": draw(E, d, ff), "w_down": draw(E, ff, d)}
    x, r = draw(T, d), draw(T, d)

    def loss_of(p, x, r, ranks):
        y, aux = moe_ffn(p, x, cfg)
        return y, aux, (y * r).sum() + 0.01 * aux / ranks

    names = sorted(params)
    want = {k: v.clone().requires_grad_() for k, v in params.items()}
    xw = x.clone().requires_grad_()
    with hints.activation_sharding({"moe_groups": D}):
        y1, aux1, loss = loss_of(want, xw, r, 1)
    g1 = dict(zip(names + ["x"], torch.autograd.grad(
        loss, [want[k] for k in names] + [xw])))

    import torch.distributed.nn.functional as dist_nn
    monkeypatch.setattr(tsh, "_all_reduce", _thread_all_reduce)
    monkeypatch.setattr(tsh, "_all_to_all", _thread_all_to_all)
    monkeypatch.setattr(dist_nn, "all_reduce",
                        lambda t, group: _ThreadAllReduce.apply(t, group))
    group, out = _ThreadGroup(D), {}
    Tr, Er = T // D, E // D

    def rank(i):
        mesh = _ThreadMesh(group, i)
        mine = {k: (v[i * Er:(i + 1) * Er] if k != "router" else v)
                .clone().requires_grad_() for k, v in params.items()}
        xi = x[i * Tr:(i + 1) * Tr].clone().requires_grad_()
        spec = {"btd": tsh.NamedSharding(mesh, ("data", None, None)),
                "moe_groups": D}
        try:
            with hints.activation_sharding(spec):
                y, aux, li = loss_of(mine, xi, r[i * Tr:(i + 1) * Tr], D)
                grads = torch.autograd.grad(li, [mine[k] for k in names]
                                            + [xi])
            out[i] = (y, aux, dict(zip(names + ["x"], grads)))
        except BaseException as e:            # raised on the test's thread
            group.barrier.abort()
            out[i] = e

    threads = [threading.Thread(target=rank, args=(i,)) for i in range(D)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(2 * PG_LIMIT_S)
    for i in range(D):
        if isinstance(out.get(i), BaseException):
            raise out[i]
    assert torch.equal(torch.cat([out[i][0] for i in range(D)]), y1)
    for i in range(D):
        # the ranks' means of the routing fractions, summed (moe.route):
        # another order of the same fp32 sum
        torch.testing.assert_close(out[i][1], aux1, rtol=0, atol=1e-6)
    got = {k: torch.cat([out[i][2][k] for i in range(D)])
           for k in ("w_gate", "w_up", "w_down", "x")}
    got["router"] = sum(out[i][2]["router"] for i in range(D))
    for k, g in g1.items():
        torch.testing.assert_close(got[k], g, rtol=0, atol=1e-6,
                                   msg=lambda m, k=k: f"{k}: {m}")


def _ref_bytes(arch, multi, itemsize=None):
    mesh = FakeMesh(multi)
    shapes = jax.eval_shape(JaxModel(jax_get_config(arch),
                                     param_dtype=jnp.bfloat16).init,
                            jax.random.PRNGKey(0))
    dtypes = {"/".join(str(getattr(k, "key", k)) for k in p): l.dtype
              for p, l in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    total = 0
    for key, (spec, shape) in _specs(arch, multi).items():
        shards = 1
        for ax in spec:
            for a in (() if ax is None else (ax,) if isinstance(ax, str)
                      else ax):
                shards *= mesh.shape[a]
        size = itemsize or np.dtype(dtypes[key]).itemsize
        total += math.prod(shape) // shards * size
    return total


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dryrun_bytes_equal_reference_shard_sums(arch):
    """The dry-run record's ``bytes_per_chip`` (``dryrun.shard_bytes``; a
    whole record, trace included, is ``tests/test_torch_dryrun.py``'s)."""
    shape = next(s for s in INPUT_SHAPES if INPUT_SHAPES[s].kind == "train"
                 and pair_is_supported(arch, s))
    model = Model(get_config(arch), param_dtype=torch.bfloat16,
                  device="meta", remat=True)
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        by = dryrun.shard_bytes(model, INPUT_SHAPES[shape], mesh)
        assert by["params"] == _ref_bytes(arch, multi)
        # fp32 mu and nu follow the params' shards; the int32 step
        assert by["opt_state"] == 2 * _ref_bytes(arch, multi, 4) + 4
        assert mesh.size == (512 if multi else 256)


def test_model_flops_and_roofline_rates():
    for arch in ARCH_IDS:
        for name, shape in INPUT_SHAPES.items():
            assert hlo_analysis.model_flops_for(get_config(arch), shape) == \
                jhlo.model_flops_for(jax_get_config(arch), JAX_SHAPES[name])
    t = hlo_analysis.roofline(2e15, 1e13, 9e11, 4, model_flops=1e15)
    assert t.compute_s == 2e15 / 989e12 and t.memory_s == 1e13 / 3.35e12
    assert t.collective_s == 9e11 / H100.ici_bw
    assert t.dominant == "memory" and t.useful_flops_ratio == 0.5
