"""Logical-axis sharding rules: the counterpart of the JAX package's
``distributed/sharding.py``, with the same rules and divisibility
fallbacks.

Mesh: (data, model) on one pod, (pod, data, model) across pods
(``launch/mesh.py``). A mesh here is either a described one (anything with
``shape``, a dict of axis sizes by name, and ``axis_names``: the production
meshes, which touch no device) or a ``torch.distributed`` ``DeviceMesh``
with ``mesh_dim_names``; the rules read only axis sizes.

Past one rank the training step is ZeRO-3 over the data-parallel axes,
expert-parallel over them and tensor-parallel over "model", as the
reference's GSPMD step computes it: ``gather_at_use`` gathers each weight
over its FSDP axes where it is used (a layer's leaves inside the layer's
body, ``models/transformer.py``) and keeps a leaf the rules shard on
"model" as the rank's block, and an MoE expert weight sharded over the
axes that split the batch as the rank's block of experts; every rank
takes its block of the global batch (``batch_block``), and the gather's
backward sums the gradients over the axes that split the batch
(``batch_axes``). The model code runs the Megatron pair on a "model"
block (``model_block``, ``copy_to_model`` / ``reduce_from_model``, over
the ``"model"`` hint's group), trades the dispatched tokens with the
ranks that hold their experts (``expert_block``, ``exchange_experts``:
one all-to-all each way) and a decode on a sequence-sharded cache
combines its softmax across the sequence's ranks (``seq_block``). Axes of
size 1 keep every leaf whole and issue no collective.

Baseline scheme (uniform across all ten architectures, as the reference):

  * FFN + vocab: tensor-parallel over "model" (w_gate / w_up shard d_ff,
    w_down shards it back; the embedding and unembedding shard the vocab);
  * attention + SSM mixers: data-parallel compute, weights replicated over
    "model" and FSDP-sharded over the data / pod axes;
  * MoE experts: the expert dim over the data / pod axes when divisible,
    else FSDP over d_model; d_ff over "model" within each expert;
  * decode KV caches: sequence-sharded over "model", batch over data when
    divisible (else the sequence over data × model).

A spec is a tuple with one entry per tensor dimension: ``None``
(replicated), a mesh-axis name, or a tuple of names (sharded over their
product, major to minor) — the reference's ``PartitionSpec`` entries.
``to_placements`` turns a spec into DTensor placements on a
``DeviceMesh``: ``Shard(d)`` on every mesh dimension that shards tensor
dimension ``d``, ``Replicate()`` on the others.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import InputShape
from repro_torch.tree import map_with_path, path_key, tree_map

Spec = Tuple[Any, ...]


def axis_sizes(mesh: Any) -> Dict[str, int]:
    """Axis name -> size of a described mesh or a ``DeviceMesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def fsdp_axes(mesh: Any) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def _axis_size(mesh: Any, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _fits(mesh: Any, dim: int, axes) -> bool:
    return dim % _axis_size(mesh, axes) == 0


def _p(n_lead: int, *spec) -> Spec:
    return tuple([None] * n_lead + list(spec))


# replicated-over-model, FSDP-over-data weights (attention + SSM mixers)
_DP_IN = {"wq", "wk", "wv", "in_proj"}    # [d_in, n]: FSDP d_in
_DP_OUT = {"wo", "out_proj"}              # [n, d_out]: FSDP d_out
# Megatron TP pair (dense FFN)
_TP_COL = {"w_gate", "w_up"}              # [d, ff]: FSDP d, TP ff
_TP_ROW = {"w_down"}                      # [ff, d]: TP ff, FSDP d


def _normalize(spec) -> Spec:
    """A spec as ``PartitionSpec`` stores it: a one-axis tuple is the
    axis name."""
    return tuple(ax[0] if isinstance(ax, tuple) and len(ax) == 1 else ax
                 for ax in spec)


def _spec_for(path: str, shape, mesh: Any) -> Spec:
    return _normalize(_rule(path, shape, mesh))


def _rule(path: str, shape, mesh: Any) -> Spec:
    fsdp = fsdp_axes(mesh)
    stacked = ("blocks" in path)
    n_lead = 1 if stacked else 0
    name = path.split("/")[-1]
    nd = len(shape)

    def fit(dim, axes):
        return axes if _fits(mesh, shape[dim], axes) else None

    if name == "embed":
        return (fit(0, "model"), None)
    if name == "unembed":
        return (fit(0, fsdp), fit(1, "model"))
    if name == "router":
        return _p(n_lead, None, None) if nd == n_lead + 2 else (None,) * nd
    if name in ("w_gate", "w_up", "w_down") and nd == n_lead + 3:
        # MoE expert weights [L, E, a, b]: gate/up are [.., E, d, ff]
        # (TP the ff output), down is [.., E, ff, d] (TP the ff input).
        tp_dim = n_lead + (2 if name != "w_down" else 1)
        other = n_lead + (1 if name != "w_down" else 2)
        spec: List[Any] = [None] * nd
        spec[tp_dim] = fit(tp_dim, "model")
        if _fits(mesh, shape[n_lead], fsdp):
            spec[n_lead] = fsdp           # expert parallelism
        elif spec[other] is None:
            spec[other] = fit(other, fsdp)  # grok: FSDP d_model instead
        return tuple(spec)
    if nd == n_lead + 2:
        i, o = n_lead, n_lead + 1
        if name in _DP_IN:
            return _p(n_lead, fit(i, fsdp), None)
        if name in _DP_OUT:
            return _p(n_lead, None, fit(o, fsdp))
        if name in _TP_COL:
            return _p(n_lead, fit(i, fsdp), fit(o, "model"))
        if name in _TP_ROW:
            return _p(n_lead, fit(i, "model"), fit(o, fsdp))
    # conv kernels, norms, biases, 1D per-layer params: replicate
    return (None,) * nd


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the counterpart of ``jax.sharding.NamedSharding``.
    ``placements`` needs a ``DeviceMesh``; a described mesh gives only
    ``shard_shape``."""
    mesh: Any
    spec: Spec

    def __post_init__(self):
        object.__setattr__(self, "spec", _normalize(self.spec))

    @property
    def placements(self) -> list:
        return to_placements(self.spec, self.mesh)

    def shard_shape(self, shape) -> Tuple[int, ...]:
        """One device's block of a tensor of ``shape`` (every sharded dim
        divides evenly: the rules shard nothing else)."""
        spec = tuple(self.spec) + (None,) * (len(shape) - len(self.spec))
        return tuple(int(n) // _axis_size(self.mesh, ax)
                     for n, ax in zip(shape, spec))


def to_placements(spec: Spec, mesh: Any) -> list:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dimension:
    ``Shard(d)`` where the mesh axis shards tensor dimension ``d``."""
    from torch.distributed.tensor import Replicate, Shard
    by_axis: Dict[str, int] = {}
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        for a in ((ax,) if isinstance(ax, str) else ax):
            by_axis[a] = d
    return [Shard(by_axis[a]) if a in by_axis else Replicate()
            for a in axis_sizes(mesh)]


def param_shardings(model, mesh: Any) -> Any:
    """``NamedSharding`` tree matching ``model.init``'s output (shapes from
    the meta device: no allocation)."""
    shapes = model.abstract_params()
    return map_with_path(
        lambda path, leaf: NamedSharding(
            mesh, _spec_for(path_key(path), tuple(leaf.shape), mesh)),
        shapes)


def opt_state_shardings(param_sh: Any, mesh: Any) -> Any:
    """OptState(step, mu, nu): moments follow the params; step replicated."""
    from repro_torch.training.optimizer import OptState
    return OptState(step=NamedSharding(mesh, ()),
                    mu=tree_map(lambda s: s, param_sh),
                    nu=tree_map(lambda s: s, param_sh))


def batch_shardings(model, shape: InputShape, mesh: Any) -> Dict[str, Any]:
    """Shardings for the input batch of the step selected by shape.kind."""
    dp = fsdp_axes(mesh)
    B = shape.global_batch
    bspec = dp if _fits(mesh, B, dp) else (
        "data" if _fits(mesh, B, "data") else None)
    out: Dict[str, Any] = {}
    for key, val in model.input_specs(shape).items():
        if key == "cache":
            out[key] = cache_shardings(model, val, mesh, shape)
        elif key in ("tokens", "labels"):
            out[key] = NamedSharding(mesh, (bspec, None))
        else:  # patch_embeds / frames: [B, T, d]
            out[key] = NamedSharding(mesh, (bspec, None, None))
    return out


def cache_shardings(model, cache_shapes: Any, mesh: Any,
                    shape: InputShape) -> Any:
    """Decode-cache shardings: sequence over "model" (plus data when the
    batch can't use it), batch over data when divisible."""
    dp = fsdp_axes(mesh)
    B = shape.global_batch
    batch_ok = _fits(mesh, B, dp)
    bspec = dp if batch_ok else None
    seq_axes = ("model",) if batch_ok else tuple(list(dp) + ["model"])

    def seq_spec(dim: int):
        if _fits(mesh, dim, seq_axes):
            return seq_axes
        return "model" if _fits(mesh, dim, "model") else None

    def spec_leaf(path, leaf):
        name = path[-1] if path else ""
        nd = len(leaf.shape)
        if name in ("k", "v", "cross_k", "cross_v", "k_scale", "v_scale"):
            # [L, B, Hkv, S, hd]
            return NamedSharding(mesh, (None, bspec, None,
                                        seq_spec(leaf.shape[3]), None))
        if name == "h":      # [L, B, H, P, N] — small recurrent state
            return NamedSharding(mesh, (None, bspec, None, None, None))
        if name == "conv":   # [L, B, K-1, convdim]
            return NamedSharding(mesh, (None, bspec, None, None))
        if name == "pos":
            return NamedSharding(mesh, (bspec,) if nd == 1 else ())
        return NamedSharding(mesh, (None,) * nd)

    return map_with_path(spec_leaf, cache_shapes)


# ---------------------------------------------------------------------------
# placing tensors on a DeviceMesh
# ---------------------------------------------------------------------------

def distribute(tree: Any, shardings: Any) -> Any:
    """Each tensor of ``tree`` as a DTensor placed by the matching
    ``NamedSharding`` (on a ``DeviceMesh``). A meta tensor (the dry-run)
    has no data to scatter: its DTensor holds a new meta tensor of one
    rank's block."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def place(t, s):
        if t.is_meta:
            block = torch.empty(s.shard_shape(tuple(t.shape)), dtype=t.dtype,
                                device="meta")
            return DTensor.from_local(block, s.mesh, s.placements,
                                      run_check=False)
        return distribute_tensor(t, s.mesh, s.placements)

    return tree_map(place, tree, shardings)


_EXPERT_WEIGHTS = ("w_gate", "w_up", "w_down")


def _expert_axes(path, t, grad_axes) -> Tuple[str, ...]:
    """The mesh axes (of size > 1, not "model") over which the DTensor
    ``t`` at ``path``, an MoE expert weight ([L, E, a, b] or one layer's
    [E, a, b]), shards its expert dimension, where each of them splits
    the batch (``grad_axes``): the rank then keeps its block of experts
    and trades tokens with the others (``moe.moe_ffn``). () for any other
    leaf, and where the batch is whole on those ranks (the experts are
    gathered)."""
    from torch.distributed.tensor import Shard
    if not path or path[-1] not in _EXPERT_WEIGHTS or "moe" not in path:
        return ()
    mesh = t.device_mesh
    dim = t.dim() - 3
    axes = tuple(a for i, (a, p) in enumerate(zip(mesh.mesh_dim_names,
                                                  t.placements))
                 if isinstance(p, Shard) and p.dim == dim
                 and a != "model" and mesh.size(i) > 1)
    return axes if axes and set(axes) <= set(grad_axes) else ()


def gather_at_use(tree: Any, grad_axes: Any = None) -> Any:
    """Every DTensor leaf gathered over its FSDP axes (ZeRO-3's gather of
    the weights at use), differentiably, to a local tensor. A leaf sharded
    on a "model" axis of size > 1 stays this rank's "model" block: the
    tensor-parallel compute reads it as such (``model_block``). An MoE
    expert weight whose experts are sharded over axes that each split the
    batch stays this rank's block of experts (``_expert_axes``; the model
    code reads it with ``expert_block``). Other leaves pass through.

    ``grad_axes``: the mesh axes whose ranks hold different blocks of the
    batch; by default the ``"btd"`` hint's (``batch_axes``), () outside
    it. The gathered weight's gradient is ``Partial`` on them, so the
    backward reduce-scatters (sums) the ranks' gradients into the weight's
    own placements; on "model" it is the rank's own block (or
    ``Replicate``, the Megatron pair making every "model" rank's gradient
    of a replicated weight the same), and ``Replicate`` on the other axes,
    whose ranks compute the same block and so the same gradient (no sum
    there). A block of experts keeps its ``Shard`` on its axes: the
    token exchange brought every rank's tokens to it, so its gradient is
    already the whole batch's (a sum over those axes would count each
    token once a rank). With no batch axes every rank's gradient is taken
    as the whole one: right only when every rank sees the whole batch."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if grad_axes is None:
        grad_axes = batch_axes()[1]

    def gather(path, t):
        if not isinstance(t, DTensor):
            return t
        mesh = t.device_mesh
        names = mesh.mesh_dim_names
        experts = _expert_axes(path, t, grad_axes)
        kept = [p if (a == "model" or a in experts) and mesh.size(i) > 1
                else Replicate()
                for i, (a, p) in enumerate(zip(names, t.placements))]
        if not any(isinstance(p, Shard) for p in kept):
            if not grad_axes:
                return t.full_tensor()
            return t.full_tensor(grad_placements=[
                Partial() if a in grad_axes else Replicate()
                for a in names])
        grad = [Partial() if a in grad_axes and a not in experts else p
                for a, p in zip(names, kept)]
        return t.redistribute(mesh, kept).to_local(grad_placements=grad)

    return map_with_path(gather, tree)


def batch_axes() -> Tuple[Any, Tuple[str, ...]]:
    """(mesh, the mesh axes of size > 1 over which this rank holds a block
    of the batch), read from the ``"btd"`` activation hint the training
    launcher sets (``distributed/hints.py``); (None, ()) outside such a
    context, on a one-rank mesh, and when the batch is replicated."""
    from repro_torch.distributed.hints import static_hint
    sh = static_hint("btd")
    if sh is None or not sh.spec or sh.spec[0] is None:
        return None, ()
    ax = sh.spec[0]
    sizes = axis_sizes(sh.mesh)
    axes = tuple(a for a in ((ax,) if isinstance(ax, str) else ax)
                 if sizes[a] > 1)
    return (sh.mesh, axes) if axes else (None, ())


def batch_block(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This rank's block of every leaf of the global ``batch``, split on
    its leading (batch) dimension as the ``"btd"`` hint splits the batch
    (``local_block``); ``batch`` itself where the ranks hold it whole
    (``batch_axes``)."""
    mesh, axes = batch_axes()
    if not axes:
        return batch
    from repro_torch.distributed.hints import static_hint
    spec = static_hint("btd").spec[:1]
    return {k: local_block(v, NamedSharding(mesh, spec))
            for k, v in batch.items()}


def all_reduce_sum(t: torch.Tensor, mesh: Any, axes: Tuple[str, ...], *,
                   differentiable: bool = False) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``axes`` of ``mesh`` (one
    all-reduce on each axis's process group, so ranks that differ on other
    axes are not added). ``differentiable``: through
    ``torch.distributed.nn``, whose backward all-reduces (sums) the
    incoming gradients; else on a copy, outside autograd."""
    for a in axes:
        group = mesh.get_group(a)
        if differentiable:
            from torch.distributed.nn.functional import all_reduce
            t = all_reduce(t, group=group)
        else:
            t = _all_reduce(t.detach(), group)
    return t


def local_block(t: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's block of the global tensor ``t`` under ``sharding`` (on
    a ``DeviceMesh``): along each sharded dimension, the block at the
    rank's coordinates on its axes, major to minor (pod before data, as
    the reference's ``P(("pod", "data"))``), as DTensor's ``Shard``
    places it. Every sharded dimension divides evenly."""
    coord = dict(zip(sharding.mesh.mesh_dim_names,
                     sharding.mesh.get_coordinate()))
    sizes = axis_sizes(sharding.mesh)
    for d, ax in enumerate(sharding.spec):
        if ax is None:
            continue
        idx, n = 0, 1
        for a in ((ax,) if isinstance(ax, str) else ax):
            idx, n = idx * sizes[a] + coord[a], n * sizes[a]
        if t.shape[d] % n:
            raise ValueError(f"dimension {d} of {tuple(t.shape)} does not "
                             f"divide over {ax} ({n})")
        size = t.shape[d] // n
        t = t.narrow(d, idx * size, size)
    return t


# ---------------------------------------------------------------------------
# tensor-parallel compute over "model"
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """The "model" axis of a ``DeviceMesh``: the group the Megatron
    collectives run on, its size and this rank's coordinate on it."""
    mesh: Any

    @property
    def size(self) -> int:
        return axis_sizes(self.mesh)["model"]

    @property
    def rank(self) -> int:
        return self.mesh.get_local_rank("model")

    @property
    def group(self):
        return self.mesh.get_group("model")


def model_axis() -> Any:
    """The ``ModelAxis`` of the ``"model"`` hint (``launch/mesh.
    production_hints`` sets it on a ``DeviceMesh`` whose "model" axis is
    larger than 1); None without it, and the model code takes the plain
    path."""
    from repro_torch.distributed.hints import static_hint
    mesh = static_hint("model")
    return None if mesh is None else ModelAxis(mesh)


def model_block(t: torch.Tensor, dim: int, full: Any
                ) -> Tuple[Any, int]:
    """(the ``ModelAxis``, the offset of ``t``'s block) where ``t`` is this
    rank's "model" block of a dimension ``full`` long at ``dim``
    (``gather_at_use`` keeps the block of a leaf the rules shard on
    "model"); (None, 0) where ``t`` holds the dimension whole (no hint, or
    a ``_fits`` fallback that replicated it) or ``full`` is None: then no
    collective runs."""
    n = int(t.shape[dim])
    if full is None or n == full:
        return None, 0
    ax = model_axis()
    if ax is None or n * ax.size != full:
        raise ValueError(f"a block of {n} of a dimension of {full} needs "
                         f"the 'model' hint of a mesh whose model axis "
                         f"splits it")
    return ax, ax.rank * n


@dataclasses.dataclass(frozen=True)
class ExpertAxes:
    """The mesh axes over which an MoE layer's experts are sharded (and
    the batch with them), major to minor: the group the token exchange
    runs on (one group of the flattened axes within this rank's "model"
    index), its size and this rank's index in it, pod-major as
    ``local_block`` counts it."""
    mesh: Any
    axes: Tuple[str, ...]

    @property
    def size(self) -> int:
        return _axis_size(self.mesh, self.axes)

    @property
    def rank(self) -> int:
        sizes = axis_sizes(self.mesh)
        idx = 0
        for a in self.axes:
            idx = idx * sizes[a] + self.mesh.get_local_rank(a)
        return idx

    @property
    def group(self):
        if len(self.axes) == 1:
            return self.mesh.get_group(self.axes[0])
        return _flat_group(self.mesh, self.axes)


def _flat_group(mesh: Any, axes: Tuple[str, ...]):
    """The process group of this rank and the ranks that differ from it
    only on ``axes``, in pod-major order: made once a mesh, every rank
    making every such group in the same order (as ``new_group`` asks),
    and kept on the mesh. Not ``DeviceMesh._flatten``: a flattened mesh
    registered there changes how DTensor plans every later redistribution
    over those axes, so a step's gathers would depend on whether an MoE
    layer ran before them."""
    import torch.distributed as dist
    cache = mesh.__dict__.setdefault("_flat_groups", {})
    if axes not in cache:
        names = list(mesh.mesh_dim_names)
        inner = [names.index(a) for a in axes]
        outer = [i for i in range(len(names)) if i not in inner]
        ranks = mesh.mesh.permute(*outer, *inner).reshape(
            -1, _axis_size(mesh, axes)).tolist()
        cache[axes] = dist.new_subgroups_by_enumeration(ranks)[0]
    return cache[axes]


def expert_block(t: torch.Tensor, dim: int, full: Any
                 ) -> Tuple[Any, int]:
    """(the ``ExpertAxes``, the index of ``t``'s first expert) where ``t``
    is this rank's block of experts of an expert dimension ``full`` long
    at ``dim`` (``gather_at_use`` keeps the block where the experts are
    sharded over the axes that split the batch, which the ``"btd"`` hint
    names); (None, 0) where ``t`` holds every expert (no hint, or a
    ``_fits`` fallback): then no collective runs."""
    n = int(t.shape[dim])
    if full is None or n == full:
        return None, 0
    mesh, axes = batch_axes()
    ax = ExpertAxes(mesh, axes) if axes else None
    if ax is None or n * ax.size != full:
        raise ValueError(f"a block of {n} of {full} experts needs the "
                         f"'btd' hint of a mesh whose batch axes split "
                         f"them")
    return ax, ax.rank * n


class _ExchangeExperts(torch.autograd.Function):
    """The all-to-all of the token exchange: block j of dimension 0 to
    rank j of the group, block i of the result from rank i. With equal
    blocks it is its own inverse, so its backward is the same exchange of
    the gradient (each block returns to the rank that sent it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def exchange_experts(x: torch.Tensor, ax: ExpertAxes) -> torch.Tensor:
    """``x`` [ax.size, ...]: its block j sent to expert rank j; returns
    the blocks the ranks sent this one, in their rank order."""
    return _ExchangeExperts.apply(x, ax.group)


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


def _all_reduce(t: torch.Tensor, group, op=None) -> torch.Tensor:
    import torch.distributed as dist
    t = t.clone()
    dist.all_reduce(t, op=op or dist.ReduceOp.SUM, group=group)
    return t


class _CopyToModel(torch.autograd.Function):
    """Megatron's *f*: identity forward, all-reduce over "model" backward
    (at a column-parallel input, whose ranks each return the gradient of
    their block's share)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's *g*: all-reduce over "model" forward, identity backward
    (at a row-parallel output: every rank's output, so its gradient, is
    the same). Not ``torch.distributed.nn``'s all-reduce, whose backward
    all-reduces too and would return a replicated gradient M times over."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, ax: ModelAxis) -> torch.Tensor:
    return _CopyToModel.apply(x, ax.group)


def reduce_from_model(x: torch.Tensor, ax: ModelAxis) -> torch.Tensor:
    return _ReduceFromModel.apply(x, ax.group)


def max_over_model(x: torch.Tensor, ax: ModelAxis) -> torch.Tensor:
    """The elementwise max of ``x`` over the "model" ranks, outside
    autograd."""
    import torch.distributed as dist
    return _all_reduce(x.detach(), ax.group, dist.ReduceOp.MAX)


def gather_from_model(x: torch.Tensor, ax: ModelAxis,
                      dim: int = -1) -> torch.Tensor:
    """The "model" ranks' blocks of ``x`` concatenated along ``dim`` in
    rank order, outside autograd (the logits a server takes its greedy
    token from)."""
    import torch.distributed as dist
    x = x.detach().contiguous()
    out = x.new_empty((ax.size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=ax.group)
    return torch.cat(out.chunk(ax.size, dim=0), dim=dim)


@dataclasses.dataclass(frozen=True)
class SeqBlock:
    """This rank's block of a decode cache's sequence dimension, sharded
    over ``axes`` (major to minor) of ``mesh``: columns ``offset`` to
    ``offset`` + the block's length of ``total``."""
    mesh: Any
    axes: Tuple[str, ...]
    offset: int
    total: int

    def all_reduce(self, t: torch.Tensor, op=None) -> torch.Tensor:
        """``t`` reduced over the ranks of ``axes`` (one all-reduce an
        axis), outside autograd."""
        for a in self.axes:
            t = _all_reduce(t, self.mesh.get_group(a), op)
        return t


def seq_block(t: torch.Tensor, dim: int) -> Any:
    """The ``SeqBlock`` of a DTensor cache leaf sharded on ``dim`` over
    mesh axes of size > 1 (``cache_shardings``); None for a plain tensor
    or a leaf that holds ``dim`` whole."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(t, DTensor):
        return None
    mesh = t.device_mesh
    axes = tuple(a for i, (a, p) in enumerate(zip(mesh.mesh_dim_names,
                                                   t.placements))
                 if isinstance(p, Shard) and p.dim == dim
                 and mesh.size(i) > 1)
    if not axes:
        return None
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = axis_sizes(mesh)
    idx, n = 0, 1
    for a in axes:
        idx, n = idx * sizes[a] + coord[a], n * sizes[a]
    size = int(t.to_local().shape[dim])
    return SeqBlock(mesh, axes, idx * size, size * n)


def place_block(t: torch.Tensor, sharding: NamedSharding,
                batch_dim: int) -> torch.Tensor:
    """A DTensor placed by ``sharding`` from ``t``, this rank's block of
    the batch (dimension ``batch_dim``) and whole on the others: ``t`` is
    cut to the rank's block of every other sharded dimension (a prefill's
    cache, kept as the decode's sequence-sharded cache)."""
    from torch.distributed.tensor import DTensor
    spec = list(sharding.spec) + [None] * (t.dim() - len(sharding.spec))
    spec[batch_dim] = None
    block = local_block(t, NamedSharding(sharding.mesh, tuple(spec)))
    return DTensor.from_local(block.contiguous(), sharding.mesh,
                              sharding.placements, run_check=False)


def placed_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t``, this rank's block, as a DTensor placed as ``like`` where
    ``like`` is one; ``t`` itself otherwise."""
    from torch.distributed.tensor import DTensor
    if not isinstance(like, DTensor):
        return t
    return DTensor.from_local(t, like.device_mesh, like.placements,
                              run_check=False)


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; a plain tensor itself."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered (not differentiably); a plain tensor itself."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


__all__ = [
    "ExpertAxes", "ModelAxis", "NamedSharding", "SeqBlock",
    "all_reduce_sum", "axis_sizes", "batch_axes", "batch_block",
    "batch_shardings", "cache_shardings", "copy_to_model", "distribute",
    "exchange_experts", "expert_block", "fsdp_axes", "full",
    "gather_at_use", "gather_from_model", "local", "local_block",
    "max_over_model", "model_axis", "model_block", "opt_state_shardings",
    "param_shardings", "place_block", "placed_like", "reduce_from_model",
    "seq_block", "to_placements",
]
