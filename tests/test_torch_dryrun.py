"""The port's traced step accounting (``launch/step_cost.py``) and its
dry-run (``launch/dryrun.py``), on the CPU.

  * dot FLOPs: the port's train, prefill and decode steps at world 1, on
    meta tensors, count exactly the dot FLOPs of the JAX package's
    compiled step (``hlo_parse.analyze_hlo``) for ``test_dryrun_small``'s
    twelve cases (smoke configs, B 2, S 64, fp32, remat on train), but
    for the rows of ``COUNTING_DIFFERENCES``, each with its closed form;
  * collectives: the gemma3-1b, grok-1 and llama4 smoke train steps,
    traced as rank 0 of fake worlds of (data 2, model 2), (pod 2, data 2,
    model 2), (data 1, model 4) and (data 4, model 1), move the operand
    bytes of each kind that closed forms computed from ``param_shardings``
    give: the ZeRO-3 gathers over the FSDP axes only, a layer's inside its
    remat body (so again in the recompute), the gradients' reductions, the
    Megatron and vocab-parallel all-reduces over "model", and the MoE
    token exchange (all-to-all) where the experts divide the data axes,
    whose expert weights then move nothing else;
  * compute split: per-chip dot FLOPs on (2, 2) and (1, 4) for gemma3-1b
    train / prefill / decode and grok-1 train, and on (4, 1) for llama4
    train under ``moe_groups`` = 4, equal the reference's GSPMD count (its
    step jitted under its shardings on 4 forced host devices, in one
    subprocess) less the rows of ``GSPMD_DIFFERENCES``, GSPMD's choices
    beyond the documented rule, each in closed form; within 5 % of it but
    for gemma3-1b decode on (2, 2); on that llama4 step the reference's
    compiled module moves all-to-all bytes too;
  * the Megatron pair's collectives (one all-reduce: *f* backward, *g*
    forward), ``gather_at_use`` keeping a leaf's "model" block and an
    expert leaf's block of experts (its gradient moved by nothing), and
    the layer-wise gather's peak below the whole tree's;
  * ``fake_world`` starts and destroys its group, and refuses to start
    while one is live; no test leaves a group live;
  * ``StepCounter`` on small functions (FLOPs, bytes, live storage, the
    five collective kinds, a sixth raising) and one full-config record.

Run as a script (``python tests/test_torch_dryrun.py gspmd`` with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``) it prints the
reference's GSPMD counts (FLOPs, collective bytes) as one JSON line.
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
from repro_torch.models.moe import capacity
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


def _expert_axes(path, spec, sizes, batch_axes):
    """The mesh axes over which an MoE expert leaf at ``path`` keeps its
    block of experts: those (of size > 1) that shard its expert dimension,
    when each splits the batch; () for any other leaf."""
    if path[-1] not in ("w_gate", "w_up", "w_down") or "moe" not in path:
        return set()
    ax = spec[len(spec) - 3]
    axes = {a for a in ((ax,) if isinstance(ax, str) else ax or ())
            if sizes[a] > 1}
    return axes if axes and axes <= set(batch_axes) else set()


def _closed_form(model, sizes, batch):
    """Operand bytes of each kind in one train step of ``model`` (fp32
    params, remat) as rank 0 of a mesh of ``sizes``, ZeRO-3 over the
    data / pod axes, expert-parallel over them and tensor-parallel over
    "model", from the sharding rules:

      * the gather at use, over the FSDP axes only: one all-gather a data
        or pod axis that shards a leaf, the last axis first, each of the
        block gathered so far, starting from the rank's shard (a leaf
        sharded on "model" stays its "model" block, an expert leaf whose
        experts the batch axes shard stays its block of experts: no
        gather); a layer's leaves inside the layer's remat body, so twice
        (the forward and the recompute), the others once a step;
      * the gradient back to the leaf's placements, starting from the
        leaf's "model" block: over each axis that splits the batch, in mesh
        order, a reduce-scatter where that axis shards the leaf, else an
        all-reduce, of the gradient as it stands; for a leaf that keeps a
        "model" shard, DTensor's planner all-reduces over every batch axis
        but the last that shards it (pod before data) and reduce-scatters
        over that last, each of the gradient unsliced; none for a block
        of experts (its gradient already holds every rank's tokens);
      * the gradient norm: an fp32 scalar all-reduce a sharding axis a
        leaf ("model" included); the loss: its target count and its value,
        an fp32 scalar each, one all-reduce a batch axis;
      * MoE: ``frac`` and ``mean_p`` ([E] fp32) all-reduced a batch axis
        in the forward and again in the remat recompute, and ``mean_p``'s
        gradient once, each layer;
      * the token exchange, where the experts are blocks: the rank's
        expert buffer [E, C, d] (one group, C the capacity of its T
        tokens) all-to-all to the experts' ranks and back, in the
        forward, again in the recompute (the combine saves what follows
        it) and in the backward: six a layer;
      * the Megatron collectives over "model", when it is larger than 1,
        each of the rank's T tokens (its block of the batch) in fp32: the
        vocab-parallel embedding's all-reduce of [T, d] (outside remat);
        each dense layer's *f* backward and *g* forward, [T, d] each (the
        recompute stops before *g*: nothing saved for the backward
        follows it); each MoE layer's *f* backward and *g* forward and
        recompute of the expert buffer [E, C, d] (the combine after *g*
        saves it); the cross-entropy's max, sum of exps and gold logit, T
        fp32 each, in the forward and in the recompute, and its *f*
        backward of [T, d].
    """
    from repro_torch.tree import flatten_with_path
    mesh = MeshShape(dict(sizes))
    dp = fsdp_axes(mesh)
    split = math.prod(sizes[a] for a in dp)
    batch_axes = [a for a in dp if sizes[a] > 1] if batch % split == 0 \
        else []
    M = sizes["model"]
    want = dict.fromkeys(COLLECTIVE_OPS, 0)
    experts_split = False
    for (path, t), sh in zip(flatten_with_path(model.abstract_params()),
                             leaves(param_shardings(model, mesh))):
        axes = _axes_of(sh.spec, sizes)
        experts = _expert_axes(path, sh.spec, sizes, batch_axes)
        experts_split = experts_split or bool(experts)
        gathers = 2 if path[0] in ("blocks", "enc_blocks") else 1
        item = t.element_size()
        cur = math.prod(sh.shard_shape(tuple(t.shape))) * item
        for a in reversed(list(sizes)):
            if a in axes and a != "model" and a not in experts:
                want["all-gather"] += gathers * cur
                cur *= sizes[a]
        cur = t.numel() * item // (M if "model" in axes else 1)
        sharding = [a for a in batch_axes if a in axes]
        for a in batch_axes:
            if experts:
                break
            if a in axes and ("model" not in axes or a == sharding[-1]):
                want["reduce-scatter"] += cur
                cur //= sizes[a]
            else:
                want["all-reduce"] += cur
        want["all-reduce"] += 4 * len(axes)
    want["all-reduce"] += 2 * 4 * len(batch_axes)
    cfg = model.cfg
    T = batch // (split if batch_axes else 1) * S
    if cfg.has_moe:
        want["all-reduce"] += (cfg.num_layers * 5 * 4 * cfg.moe.num_experts
                               * len(batch_axes))
        buf = cfg.moe.num_experts * capacity(T, cfg.moe) * cfg.d_model
        if experts_split:
            want["all-to-all"] += cfg.num_layers * 6 * 4 * buf
    if M > 1:
        act = T * cfg.d_model * 4
        want["all-reduce"] += act
        if cfg.has_moe:
            want["all-reduce"] += cfg.num_layers * 3 * 4 * buf
        else:
            want["all-reduce"] += cfg.num_layers * 2 * act
        want["all-reduce"] += 2 * 3 * 4 * T + act
    return want


def _fake_trace(model, sizes, batch, kind="train"):
    with fake_world(math.prod(sizes.values())):
        return dryrun.trace_step(model, InputShape(kind, S, batch, kind),
                                 make_mesh(sizes, "cpu"))


MESHES = [{"data": 2, "model": 2}, {"pod": 2, "data": 2, "model": 2},
          {"data": 1, "model": 4}, {"data": 4, "model": 1}]


@pytest.mark.parametrize("sizes", MESHES, ids=["2x2", "2x2x2", "1x4", "4x1"])
@pytest.mark.parametrize("arch", ["gemma3-1b", "grok-1-314b",
                                  "llama4-maverick-400b-a17b"])
def test_collective_bytes_equal_closed_form(arch, sizes):
    """Every kind's bytes equal the closed form; a "model" axis of 1 adds
    no Megatron collective, and one of 4 with data 1 moves only
    all-reduces (nothing to gather, no batch to sum over). The smoke
    MoEs' 4 experts divide every data axis here, so with data > 1 they
    trade tokens by all-to-all and their expert weights are neither
    gathered nor reduce-scattered."""
    model = Model(smoke_config(arch), param_dtype=torch.float32,
                  device="meta", remat=True)
    totals, _ = _fake_trace(model, sizes, batch=4)
    want = _closed_form(model, sizes, batch=4)
    assert totals.per_collective == want
    assert totals.collective_bytes == sum(want.values())
    if sizes["data"] > 1:
        assert want["all-gather"] and want["reduce-scatter"]
    else:
        assert want["all-gather"] == want["reduce-scatter"] == 0
    assert bool(want["all-to-all"]) == (model.cfg.has_moe
                                        and sizes["data"] > 1)
    assert want["all-reduce"]


# ---------------------------------------------------------------------------
# per-chip dot FLOPs against the reference's GSPMD step
# ---------------------------------------------------------------------------

GSPMD_B = 4
GSPMD_CASES = [("gemma3-1b", "train"), ("gemma3-1b", "prefill"),
               ("gemma3-1b", "decode"), ("grok-1-314b", "train")]
GSPMD_MESHES = [(2, 2), (1, 4)]
# llama4 smoke's 4 experts over data 4, one token group a data rank: the
# reference's [G, E, C, d] all-to-all
GSPMD_EXPERTS = ("llama4-maverick-400b-a17b", "train", (4, 1))


def _gspmd_count(arch, kind, sizes):
    """The reference's per-chip dot FLOPs and collective operand bytes by
    kind on a (data, model) mesh of ``sizes`` over 4 forced host devices:
    ``jax.jit`` of its train step, ``prefill`` or ``decode_step`` with
    ``in_shardings`` from ``param_shardings`` / ``batch_shardings`` /
    ``cache_shardings`` (the train step's optimizer state from
    ``opt_state_shardings``), under the ``"btd"`` hint (for an MoE, also
    ``moe_groups`` = the data ranks and ``moe_tokens``, as its dry-run
    sets them), smoke config, fp32, B 4, S 64, remat on train, then
    ``analyze_hlo`` and ``collective_bytes`` of the compiled module. Run
    in a process of its own (``XLA_FLAGS`` must name 4 devices before jax
    starts)."""
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from repro.distributed.hints import activation_sharding
    from repro.distributed.sharding import (batch_shardings, fsdp_axes,
                                            opt_state_shardings,
                                            param_shardings)
    from repro.launch.hlo_analysis import collective_bytes
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(sizes),
                ("data", "model"))
    cfg = jax_smoke_config(arch)
    model = JaxModel(cfg, param_dtype=jnp.float32, remat=(kind == "train"))
    shape = JaxInputShape(f"{kind}_gspmd", S, GSPMD_B, kind)
    dp = fsdp_axes(mesh)
    bspec = dp if GSPMD_B % sizes[0] == 0 else None
    hints = {"btd": NamedSharding(mesh, P(bspec, None, None))}
    if cfg.has_moe and arch == GSPMD_EXPERTS[0]:
        hints["moe_groups"] = sizes[0]
        hints["moe_tokens"] = NamedSharding(mesh, P(dp, None, None))
    rng = jax.random.PRNGKey(0)
    with mesh, activation_sharding(hints):
        p_sh = param_shardings(model, mesh, rng)
        params = jax.eval_shape(model.init, rng)
        specs = model.input_specs(shape)
        b_sh = batch_shardings(model, shape, mesh)
        if kind == "train":
            o_sh = opt_state_shardings(p_sh, mesh)
            step = jax.jit(jax_train_step(model, JaxOptimizerConfig()),
                           in_shardings=(p_sh, o_sh, b_sh),
                           out_shardings=(p_sh, o_sh, None))
            lowered = step.lower(params, jax.eval_shape(jax_init_opt_state,
                                                        params), specs)
        elif kind == "prefill":
            lowered = jax.jit(lambda p, b: model.prefill(p, b, cache_len=S),
                              in_shardings=(p_sh, b_sh)).lower(params, specs)
        else:
            lowered = jax.jit(model.decode_step,
                              in_shardings=(p_sh, b_sh["tokens"],
                                            b_sh["cache"]),
                              out_shardings=(None, b_sh["cache"])).lower(
                params, specs["tokens"], specs["cache"])
        text = lowered.compile().as_text()
        return analyze_hlo(text).flops, collective_bytes(text)


@pytest.fixture(scope="module")
def gspmd_counts():
    """Every case's reference count, from one subprocess (this file run
    as a script with 4 forced host devices)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "gspmd"], env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = json.loads(proc.stdout.strip().splitlines()[-1])
    return {(a, k, tuple(m)): (f, c) for a, k, m, f, c in rows}


def _attention_widths(cfg):
    """Output widths of wq, wk, wv, wo (wo's input width is wq's)."""
    hd = cfg.resolved_head_dim
    return cfg.num_heads * hd, cfg.num_kv_heads * hd


def _gspmd_wgrad_split(cfg, kind, sizes):
    """GSPMD, train, data > 1: the weight gradients of the attention
    projections (replicated over "model", FSDP-sharded over "data") are
    split across the "model" ranks that hold one data block, each
    computing 1/M of the rows (the collective-permutes in its HLO move
    them to their data ranks); the port computes each rank's whole
    gradient, as the rule's data-parallel compute does, and reduces it
    over "data". Less by L · (1 − 1/M) · 2 · T · d · (q + k + v + o
    widths), T the chip's tokens."""
    D, M = sizes
    if kind != "train" or D == 1:
        return 0
    q, kv = _attention_widths(cfg)
    T = GSPMD_B // D * S
    return -int(cfg.num_layers * (1 - 1 / M) * 2 * T * cfg.d_model
                * (2 * q + 2 * kv))


def _gspmd_qkv_split(cfg, kind, sizes):
    """GSPMD, decode, data > 1: the q / k / v projections keep their
    FSDP-sharded weights stationary (each chip contracts its data block of
    d_model) and split the rows over "model" (permutes in, an all-reduce
    out); the port gathers the weights and projects the rank's rows whole.
    Less by L · (1 − 1/M) · 2 · B · d · (q + k + v widths), B the chip's
    rows."""
    D, M = sizes
    if kind != "decode" or D == 1:
        return 0
    q, kv = _attention_widths(cfg)
    B = GSPMD_B // D
    return -int(cfg.num_layers * (1 - 1 / M) * 2 * B * cfg.d_model
                * (q + 2 * kv))


def _gspmd_band_whole(cfg, kind, sizes):
    """GSPMD, decode: a local layer gathers its ``window`` band from the
    sequence-sharded cache and scores it whole on every chip; the port
    masks the band over the rank's block of S/M columns and combines
    across the ranks. More by 2 · 2 · B · H · hd · (window − S/M) a
    local layer (q·kᵀ and p·v) where the block is shorter than the
    window."""
    D, M = sizes
    if kind != "decode" or cfg.window_size <= S // M:
        return 0
    flags = cfg.global_layer_flags()
    local = sum(1 for g in flags if not g)
    B = GSPMD_B // D
    return (local * 2 * 2 * B * cfg.num_heads * cfg.resolved_head_dim
            * (cfg.window_size - S // M))


# The reference's GSPMD count less the port's, each a GSPMD choice beyond
# the documented rule (FFN + vocab tensor-parallel over "model", attention
# data-parallel, the decode cache sequence-sharded), in closed form.
GSPMD_DIFFERENCES = {
    "attention weight gradients split over model": _gspmd_wgrad_split,
    "decode q / k / v weight-stationary, rows over model": _gspmd_qkv_split,
    "decode local band read whole": _gspmd_band_whole,
}
# gemma3-1b decode on (2, 2) is 12 % over the reference: the
# weight-stationary q / k / v projections are GSPMD's own choice on that
# mesh (it does not make it on (1, 4)), not the rule; the 5 % bound holds
# for the other seven cases
OUTSIDE_THE_BOUND = {("gemma3-1b", "decode", (2, 2))}


@pytest.mark.parametrize("sizes", GSPMD_MESHES, ids=["2x2", "1x4"])
@pytest.mark.parametrize("arch,kind", GSPMD_CASES)
def test_per_chip_dot_flops_match_gspmd(arch, kind, sizes, gspmd_counts):
    """The port's per-chip dot FLOPs on a fake (data, model) world equal
    the reference's GSPMD count less the named differences, exactly, and
    lie within 5 % of it (but the case named above)."""
    model = Model(smoke_config(arch), param_dtype=torch.float32,
                  device="meta", remat=(kind == "train"))
    totals, _ = _fake_trace(model, {"data": sizes[0], "model": sizes[1]},
                            GSPMD_B, kind)
    want = gspmd_counts[(arch, kind, sizes)][0]
    extra = sum(f(model.cfg, kind, sizes)
                for f in GSPMD_DIFFERENCES.values())
    assert totals.flops + extra == want
    if (arch, kind, sizes) not in OUTSIDE_THE_BOUND:
        assert abs(totals.flops - want) <= 0.05 * want


def test_expert_parallel_step_trades_tokens_as_the_reference(
        gspmd_counts):
    """llama4 smoke train on (data 4, model 1), one token group a data
    rank: the reference's compiled step and the port's trace both move
    all-to-all bytes (the port's equal to the closed form; XLA counts its
    remat scan body once, so the two byte counts differ), and the port's
    per-chip dot FLOPs equal the reference's less the named
    differences."""
    arch, kind, sizes = GSPMD_EXPERTS
    flops, coll = gspmd_counts[GSPMD_EXPERTS]
    model = Model(smoke_config(arch), param_dtype=torch.float32,
                  device="meta", remat=True)
    mesh = {"data": sizes[0], "model": sizes[1]}
    totals, _ = _fake_trace(model, mesh, GSPMD_B, kind)
    assert coll["all-to-all"] > 0, coll
    want = _closed_form(model, mesh, GSPMD_B)["all-to-all"]
    assert totals.per_collective["all-to-all"] == want > 0
    extra = sum(f(model.cfg, kind, sizes)
                for f in GSPMD_DIFFERENCES.values())
    assert totals.flops + extra == flops


def test_megatron_pair_collectives():
    """On a fake (data 2, model 2) world: *f* (``copy_to_model``) issues
    nothing forward and one all-reduce of the gradient over "model"
    backward; *g* (``reduce_from_model``) one all-reduce forward and
    nothing backward (its gradient passes as it is)."""
    from repro_torch.distributed.sharding import (ModelAxis, copy_to_model,
                                                  reduce_from_model)
    x = torch.empty(8, 4, device="meta")
    with fake_world(4):
        ax = ModelAxis(make_mesh({"data": 2, "model": 2}, "cpu"))
        assert (ax.size, ax.rank) == (2, 0)
        for fn, fwd, bwd in ((copy_to_model, 0, 128), (reduce_from_model,
                                                       128, 0)):
            xg = x.clone().requires_grad_()
            y, tf, _ = count_step(lambda t: fn(t, ax), xg)
            _, tb, _ = count_step(lambda y: torch.autograd.grad(
                y.sum(), [xg]), y)
            assert tf.per_collective["all-reduce"] == fwd
            assert tb.per_collective["all-reduce"] == bwd
            assert tf.collective_bytes == fwd and tb.collective_bytes == bwd


def test_gather_keeps_the_model_block():
    """``gather_at_use`` on (data 2, model 2) gathers over "data" only: a
    leaf sharded on "model" comes back as the rank's block, one replicated
    over "model" whole; on (data 4, model 1) every leaf comes back
    whole."""
    from repro_torch.distributed.sharding import (NamedSharding, distribute,
                                                  gather_at_use)
    tree = {"w_gate": torch.empty(16, 32, device="meta"),
            "wq": torch.empty(16, 8, device="meta")}
    for sizes, want in (({"data": 2, "model": 2}, (16, 16)),
                        ({"data": 4, "model": 1}, (16, 32))):
        with fake_world(4):
            mesh = make_mesh(sizes, "cpu")
            placed = distribute(tree, {
                "w_gate": NamedSharding(mesh, ("data", "model")),
                "wq": NamedSharding(mesh, ("data", None))})
            used = gather_at_use(placed)
        assert tuple(used["w_gate"].shape) == want
        assert tuple(used["wq"].shape) == (16, 8)


def test_gather_keeps_the_expert_block():
    """On a fake (data 4, model 1) world, llama4 smoke's stacked expert
    weights (4 experts over data 4) come back from ``gather_at_use`` as
    the rank's block of one expert, [L, 1, ...], moved by no collective
    either way: their gradient keeps its ``Shard`` on "data" (a
    ``Partial`` would be reduce-scattered). With 2 experts (grok-style:
    they do not divide data 4, so the rules shard d_model instead) the
    leaf is gathered whole and its gradient reduce-scattered."""
    import dataclasses

    from torch.distributed.tensor import Shard

    from repro_torch.configs import MoEConfig
    from repro_torch.distributed.sharding import distribute, gather_at_use
    base = smoke_config("llama4-maverick-400b-a17b")
    for E, block in ((4, 1), (2, 2)):
        cfg = dataclasses.replace(base, moe=MoEConfig(num_experts=E,
                                                      top_k=1))
        model = Model(cfg, param_dtype=torch.float32, device="meta")
        moe = model.abstract_params()["blocks"]["moe"]
        with fake_world(4):
            mesh = make_mesh({"data": 4, "model": 1}, "cpu")
            sh = param_shardings(model, mesh)["blocks"]["moe"]
            placed = {k: v.requires_grad_() for k, v in distribute(
                moe, sh).items()}
            used, fwd, _ = count_step(lambda t: gather_at_use(
                {"blocks": {"moe": t}}, ("data",))["blocks"]["moe"], placed)
            loss = sum(used[k].sum() for k in ("w_gate", "w_up", "w_down"))
            grads, bwd, _ = count_step(lambda l: dict(zip(
                ("w_gate", "w_up", "w_down"), torch.autograd.grad(
                    l, [placed[k] for k in ("w_gate", "w_up", "w_down")]))),
                loss)
        for k in ("w_gate", "w_up", "w_down"):
            L, _, a, b = moe[k].shape
            assert tuple(used[k].shape) == (L, block, a, b), (E, k)
            assert grads[k].placements == placed[k].placements
        if block == 1:
            assert placed["w_gate"].placements[0] == Shard(1)
            assert fwd.collective_bytes == bwd.collective_bytes == 0
        else:
            assert fwd.per_collective["all-gather"] > 0
            assert bwd.per_collective["reduce-scatter"] > 0
        assert tuple(used["router"].shape) == tuple(moe["router"].shape)


def test_layer_gather_lowers_the_peak():
    """gemma3-1b smoke at 4 layers, train step on a fake (data 4, model 1)
    world: the peak of the step that gathers a layer inside its remat
    body lies below the peak of the same step fed the whole tree gathered
    up front by at least 3 (L − 1) layers' gathered bytes."""
    import dataclasses

    from repro_torch.distributed.hints import activation_sharding
    from repro_torch.distributed.sharding import batch_block, gather_at_use
    from repro_torch.launch.mesh import production_state
    from repro_torch.tree import leaves
    cfg = dataclasses.replace(smoke_config("gemma3-1b"), num_layers=4)
    model = Model(cfg, param_dtype=torch.float32, device="meta", remat=True)
    specs = model.input_specs(InputShape("train", S, 4, "train"))
    peaks = {}
    with fake_world(4):
        mesh = make_mesh({"data": 4, "model": 1}, "cpu")
        params, _, hints = production_state(model, model.abstract_params(),
                                            mesh, 4)
        with activation_sharding(hints):
            for whole in (False, True):
                def grads(p, b):
                    flat = leaves(p)
                    for t in flat:
                        t.requires_grad_(True)
                    used = gather_at_use(p) if whole else p
                    loss = model.loss(used, batch_block(b))
                    return torch.autograd.grad(loss, flat)

                peaks[whole] = count_step(grads, params, specs)[2][
                    "peak_bytes"]
    layer = sum(t.numel() * t.element_size()
                for t in leaves(model.abstract_params()["blocks"])
                ) // cfg.num_layers
    assert peaks[False] + (cfg.num_layers - 1) * layer <= peaks[True], (
        peaks, layer)


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


def _main(argv):
    """``test_torch_dryrun.py gspmd``: every GSPMD case's count as one
    JSON line of [arch, kind, [data, model], flops, collective bytes by
    kind]."""
    import json
    assert argv == ["gspmd"], argv
    assert len(jax.devices()) >= 4, jax.devices()
    cases = [(a, k, m) for a, k in GSPMD_CASES for m in GSPMD_MESHES]
    print(json.dumps([[a, k, list(m), *_gspmd_count(a, k, m)]
                      for a, k, m in cases + [GSPMD_EXPERTS]]))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(_main(sys.argv[1:]))
