"""The port's traced step accounting (``launch/step_cost.py``) and its
dry-run (``launch/dryrun.py``), on the CPU.

  * dot FLOPs: the port's train, prefill and decode steps at world 1, on
    meta tensors, count exactly the dot FLOPs of the JAX package's
    compiled step (``hlo_parse.analyze_hlo``) for ``test_dryrun_small``'s
    twelve cases (smoke configs, B 2, S 64, fp32, remat on train), but
    for the rows of ``COUNTING_DIFFERENCES``, each with its closed form;
  * collectives: the gemma3-1b and grok-1 smoke train steps, traced as
    rank 0 of fake worlds of 4 (data 2, model 2) and 8 (pod 2, data 2,
    model 2) ranks, move the operand bytes of each kind that closed forms
    computed from ``param_shardings`` give;
  * compute split: the dense step's per-chip dot FLOPs on (2, 2) are half
    the world-1 count and on (4, 1) a quarter ("model" ranks repeat it);
  * ``fake_world`` starts and destroys its group, and refuses to start
    while one is live; no test leaves a group live;
  * ``StepCounter`` on small functions (FLOPs, bytes, live storage, the
    five collective kinds, a sixth raising) and one full-config record.
"""
import math

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro.configs import smoke_config as jax_smoke_config
from repro.configs.base import InputShape as JaxInputShape
from repro.launch.hlo_parse import analyze_hlo
from repro.models import Model as JaxModel
from repro.training.optimizer import OptimizerConfig as JaxOptimizerConfig
from repro.training.optimizer import init_opt_state as jax_init_opt_state
from repro.training.train_loop import make_train_step as jax_train_step
from repro_torch.configs import INPUT_SHAPES, get_config, smoke_config
from repro_torch.configs.base import InputShape
from repro_torch.core import H100
from repro_torch.distributed.sharding import fsdp_axes, param_shardings
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (MeshShape, fake_world, make_mesh,
                                     make_production_mesh)
from repro_torch.launch.step_cost import COLLECTIVE_OPS, count_step
from repro_torch.models import Model
from repro_torch.training import (OptimizerConfig, init_opt_state,
                                  make_train_step)
from repro_torch.tree import leaves

ARCHS = ["gemma3-1b", "grok-1-314b", "mamba2-2.7b", "whisper-tiny"]
KINDS = ["train", "prefill", "decode"]
B, S = 2, 64


@pytest.fixture(autouse=True)
def _no_live_group():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


def _ssd_backward_dots(cfg, B, S):
    """Dot FLOPs the reference's mamba2 train step counts and the port's
    does not, a layer: (a) 2·B·H·Q·P·N, the gradient of the first chunk's
    zero initial state, which the reference's scan transposes like every
    chunk's carry and the port's loop never asks for (its h₀ is a
    constant); (b) nc · 2 · 2·B·Q·N·H, the backward of the inter-chunk
    einsum ``bin,bhpn,bih->bihp`` to C and to exp(cum), and (c)
    2 · 2·B·nc·Q²·H in the intra-chunk backward: contractions over H (and
    Q) that JAX's einsum transpose emits as ``dot_general`` and torch's
    einsum backward as a multiply and a sum, which no product counts.
    Checked also at (B, S) = (2, 128) and (4, 32)."""
    s = cfg.ssm
    Q, H, P, N = s.chunk_size, s.num_heads(cfg.d_model), s.head_dim, s.d_state
    nc = S // Q
    return cfg.num_layers * (2 * B * H * Q * P * N
                             + nc * 2 * (2 * B * Q * N * H)
                             + 2 * (2 * B * nc * Q * Q * H))


# (arch, kind) -> the reference's count less the port's, in closed form.
# The prefill rows of gemma3-1b, grok-1 and whisper-tiny (the k / v
# projected twice, which XLA merged) and gemma3-1b's decode row (a local
# layer attending over the whole cache where the reference reads its
# window) were faults of the port, repaired: they are equal now.
COUNTING_DIFFERENCES = {("mamba2-2.7b", "train"): _ssd_backward_dots}


def _reference_flops(arch, kind):
    cfg = jax_smoke_config(arch)
    shape = JaxInputShape(f"{kind}_small", S, B, kind)
    model = JaxModel(cfg, param_dtype=jnp.float32, remat=(kind == "train"))
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    specs = model.input_specs(shape)
    if kind == "train":
        step = jax.jit(jax_train_step(model, JaxOptimizerConfig()))
        lowered = step.lower(params, jax.eval_shape(jax_init_opt_state,
                                                    params), specs)
    elif kind == "prefill":
        lowered = jax.jit(lambda p, b: model.prefill(
            p, b, cache_len=S)).lower(params, specs)
    else:
        lowered = jax.jit(model.decode_step).lower(
            params, specs["tokens"], specs["cache"])
    return analyze_hlo(lowered.compile().as_text()).flops


def _port_totals(model, kind, shape):
    params = model.abstract_params()
    specs = model.input_specs(shape)
    if kind == "train":
        step = make_train_step(model, OptimizerConfig())
        return count_step(step, params, init_opt_state(params), specs)[1]
    if kind == "prefill":
        return count_step(lambda p, b: model.prefill(p, b, cache_len=S),
                          params, specs)[1]
    return count_step(model.decode_step, params, specs["tokens"],
                      specs["cache"])[1]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_dot_flops_equal_the_reference(arch, kind):
    model = Model(smoke_config(arch), param_dtype=torch.float32,
                  device="meta", remat=(kind == "train"))
    got = _port_totals(model, kind, InputShape(kind, S, B, kind)).flops
    diff = COUNTING_DIFFERENCES.get((arch, kind))
    extra = diff(model.cfg, B, S) if diff else 0
    assert got + extra == _reference_flops(arch, kind)


def _axes_of(spec, sizes):
    """The mesh axes of size > 1 that shard a leaf of ``spec``."""
    out = set()
    for ax in spec:
        if ax is not None:
            out.update((ax,) if isinstance(ax, str) else ax)
    return {a for a in out if sizes[a] > 1}


def _closed_form(model, sizes, batch):
    """Operand bytes of each kind in one ZeRO-3 train step of ``model``
    (fp32 params) as rank 0 of a mesh of ``sizes``, from the sharding
    rules:

      * the gather at use: one all-gather a mesh axis that shards a leaf,
        the last axis first, each of the block gathered so far (once a
        step: the gather is outside the remat bodies);
      * the gradient back to the leaf's placements: over each axis that
        splits the batch, in mesh order, a reduce-scatter where that axis
        shards the leaf, else an all-reduce, of the gradient as it stands;
      * the gradient norm: an fp32 scalar all-reduce a sharding axis a
        leaf; the loss: its target count and its value, an fp32 scalar
        each, one all-reduce a batch axis;
      * MoE: ``frac`` and ``mean_p`` ([E] fp32) all-reduced a batch axis
        in the forward and again in the remat recompute, and ``mean_p``'s
        gradient once, each layer.
    """
    mesh = MeshShape(dict(sizes))
    dp = fsdp_axes(mesh)
    split = math.prod(sizes[a] for a in dp)
    batch_axes = [a for a in dp if sizes[a] > 1] if batch % split == 0 \
        else []
    want = dict.fromkeys(COLLECTIVE_OPS, 0)
    for t, sh in zip(leaves(model.abstract_params()),
                     leaves(param_shardings(model, mesh))):
        axes = _axes_of(sh.spec, sizes)
        item = t.element_size()
        cur = math.prod(sh.shard_shape(tuple(t.shape))) * item
        for a in reversed(list(sizes)):
            if a in axes:
                want["all-gather"] += cur
                cur *= sizes[a]
        cur = t.numel() * item
        for a in batch_axes:
            if a in axes:
                want["reduce-scatter"] += cur
                cur //= sizes[a]
            else:
                want["all-reduce"] += cur
        want["all-reduce"] += 4 * len(axes)
    want["all-reduce"] += 2 * 4 * len(batch_axes)
    cfg = model.cfg
    if cfg.has_moe:
        want["all-reduce"] += (cfg.num_layers * 5 * 4 * cfg.moe.num_experts
                               * len(batch_axes))
    return want


def _fake_trace(model, sizes, batch, kind="train"):
    with fake_world(math.prod(sizes.values())):
        return dryrun.trace_step(model, InputShape(kind, S, batch, kind),
                                 make_mesh(sizes, "cpu"))


MESHES = [{"data": 2, "model": 2}, {"pod": 2, "data": 2, "model": 2}]


@pytest.mark.parametrize("sizes", MESHES, ids=["2x2", "2x2x2"])
@pytest.mark.parametrize("arch", ["gemma3-1b", "grok-1-314b"])
def test_collective_bytes_equal_closed_form(arch, sizes):
    model = Model(smoke_config(arch), param_dtype=torch.float32,
                  device="meta", remat=True)
    totals, _ = _fake_trace(model, sizes, batch=4)
    want = _closed_form(model, sizes, batch=4)
    assert totals.per_collective == want
    assert totals.collective_bytes == sum(want.values())
    assert want["all-gather"] and want["reduce-scatter"] and \
        want["all-reduce"]


def test_model_ranks_repeat_the_compute():
    model = Model(smoke_config("gemma3-1b"), param_dtype=torch.float32,
                  device="meta", remat=True)
    world1 = _port_totals(model, "train", InputShape("t", S, 4, "train"))
    for sizes, share in (({"data": 2, "model": 2}, 2),
                         ({"data": 4, "model": 1}, 4)):
        totals, _ = _fake_trace(model, sizes, batch=4)
        assert totals.flops * share == world1.flops


def test_fake_world_lifecycle():
    with fake_world(4):
        assert dist.get_world_size() == 4 and dist.get_backend() == "fake"
        with pytest.raises(RuntimeError, match="already live"):
            with fake_world(2):
                pass
        assert dist.get_world_size() == 4
    assert not dist.is_initialized()
    with fake_world(8):
        mesh = make_mesh({"pod": 2, "data": 2, "model": 2}, "cpu")
        assert mesh.size() == 8 and dist.get_world_size() == 8
    assert not dist.is_initialized()


def test_counter_on_small_functions():
    """mm FLOPs, in + out bytes of every op but views, and live storage:
    the arguments, then the product and the scaled copy at once."""
    x = torch.empty(8, 16, device="meta")
    w = torch.empty(16, 4, device="meta")
    out, tot, mem = count_step(lambda x, w: (x @ w).t() * 2, x, w)
    assert tuple(out.shape) == (4, 8)
    assert tot.flops == 2 * 8 * 4 * 16
    assert tot.bytes == 4 * ((128 + 64 + 32) + (32 + 32))
    assert tot.collective_bytes == 0
    assert mem == {"argument_bytes": 4 * 192, "output_bytes": 4 * 32,
                   "temp_bytes": 4 * 64, "peak_bytes": 4 * 256}


@pytest.mark.parametrize("kind,call", [
    ("all-reduce", lambda t: dist.all_reduce(t)),
    ("all-gather", lambda t: dist.all_gather_into_tensor(
        torch.empty(32, 4, device="meta"), t)),
    ("reduce-scatter", lambda t: dist.reduce_scatter_tensor(
        torch.empty(2, 4, device="meta"), t)),
    ("all-to-all", lambda t: dist.all_to_all_single(torch.empty_like(t), t)),
    ("collective-permute", lambda t: dist.send(t, 1)),
    (None, lambda t: dist.broadcast(t, 0)),
], ids=["all-reduce", "all-gather", "reduce-scatter", "all-to-all",
        "collective-permute", "broadcast"])
def test_collective_kinds(kind, call):
    """Each kind's operand bytes (8 × 4 fp32); a broadcast, none of the
    five, raises."""
    t = torch.empty(8, 4, device="meta")
    with fake_world(4):
        if kind is None:
            with pytest.raises(NotImplementedError, match="none of the five"):
                count_step(call, t)
            return
        _, tot, _ = count_step(call, t)
    assert tot.per_collective == {k: 128.0 if k == kind else 0.0
                                  for k in COLLECTIVE_OPS}


def test_full_config_record():
    """gemma3-1b train_4k on the 16 × 16 mesh: every key, the bytes a chip
    holds as ``test_torch_sharding`` checks them, the roofline from the
    counted terms at the H100's spec-sheet rates."""
    rec = dryrun.dryrun_one("gemma3-1b", "train_4k", multi_pod=False,
                            verbose=False)
    assert {"arch", "shape", "mesh", "chips", "kind", "bytes_per_chip",
            "model_flops_per_chip", "flops", "bytes", "collectives",
            "memory", "roofline", "trace_s"} <= set(rec)
    assert "not modelled" not in repr(rec)
    assert rec["chips"] == 256 and not dist.is_initialized()
    model = Model(get_config("gemma3-1b"), param_dtype=torch.bfloat16,
                  device="meta", remat=True)
    assert rec["bytes_per_chip"] == dryrun.shard_bytes(
        model, INPUT_SHAPES["train_4k"], make_production_mesh())
    coll = rec["collectives"]
    assert set(coll) == {"all-gather", "reduce-scatter", "all-reduce"}
    r = rec["roofline"]
    assert r["compute_s"] == rec["flops"] / H100.peak_flops
    assert r["memory_s"] == rec["bytes"] / H100.hbm_bw
    assert r["collective_s"] == sum(coll.values()) / H100.ici_bw
    assert r["useful_flops_ratio"] == rec["model_flops_per_chip"] / \
        rec["flops"]
    mem = rec["memory"]
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["argument_bytes"] >= rec["bytes_per_chip"]["params"]
