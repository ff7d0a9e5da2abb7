"""Meshes: the counterpart of the JAX package's ``launch/mesh.py``.

Defined as FUNCTIONS, not module constants, so importing this module
touches no device and starts no process group.

``make_production_mesh`` DESCRIBES the reference's production meshes (16 ×
16 chips a pod; 2 × 16 × 16 across two pods) by axis name and size: the
sharding rules and the dry-run read only those sizes, and no host holds
256 cards. ``make_mesh`` is a real ``DeviceMesh`` with the production axis
names over the current world of any size; ``make_host_mesh`` is its (1, 1)
case.

``ensure_process_group`` starts the world: from ``init_method`` when the
caller passes one (``file://...``, ``tcp://...``), else from the
environment as ``torchrun`` sets it (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``: ``env://``), else a world of 1 on an in-memory store (no
rendezvous). A rank on ``cuda`` takes ``cuda:LOCAL_RANK``
(``rank_device``). ``fake_world`` starts a world of any size in one
process on torch's ``"fake"`` backend, whose collectives move nothing: the
dry-run builds the production meshes on it and traces one rank's step.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from datetime import timedelta
from typing import Any, Dict, Optional, Tuple

import torch

AXES = ("data", "model")
MULTI_POD_AXES = ("pod", "data", "model")


@dataclasses.dataclass
class MeshShape:
    """A mesh described by axis name and size, with no devices."""
    shape: Dict[str, int]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16×16 = 256 chips per pod; 2 pods = 512 chips multi-pod."""
    if multi_pod:
        return MeshShape({"pod": 2, "data": 16, "model": 16})
    return MeshShape({"data": 16, "model": 16})


def rank_device(device: torch.device) -> torch.device:
    """The device this rank drives: ``cuda:LOCAL_RANK`` for a CUDA device
    (``LOCAL_RANK`` from the environment, 0 without it), else ``device``.
    Raises when the host has no card of that index: NCCL refuses two ranks
    on one card, and a rank never moves to another backend or the CPU."""
    if device.type != "cuda":
        return device
    local = int(os.environ.get("LOCAL_RANK", device.index or 0))
    count = torch.cuda.device_count()
    if local >= count:
        raise ValueError(f"LOCAL_RANK {local} needs a card cuda:{local}; "
                         f"the host has {count}")
    return torch.device("cuda", local)


def ensure_process_group(device_type: str, init_method: Optional[str] = None,
                         timeout_s: Optional[float] = None) -> bool:
    """Start the process group (nccl for ``cuda``, gloo otherwise) unless
    one exists: from ``init_method`` with ``RANK`` and ``WORLD_SIZE`` from
    the environment (0 and 1 without them), else ``env://`` when
    ``torchrun``'s variables are set, else a world of 1 on an in-memory
    store. ``timeout_s`` bounds every collective (torch's default without
    it). Returns whether it started one (the caller then destroys it)."""
    import torch.distributed as dist
    if dist.is_initialized():
        return False
    backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        torch.cuda.set_device(rank_device(torch.device("cuda")))
    kw = {} if timeout_s is None else {"timeout": timedelta(seconds=timeout_s)}
    env = os.environ
    if init_method is None and "WORLD_SIZE" in env and "MASTER_ADDR" in env:
        init_method = "env://"
    if init_method is None:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    else:
        dist.init_process_group(backend, init_method=init_method,
                                rank=int(env.get("RANK", 0)),
                                world_size=int(env.get("WORLD_SIZE", 1)),
                                **kw)
    return True


@contextlib.contextmanager
def fake_world(world_size: int):
    """A process group of ``world_size`` ranks on torch's ``"fake"``
    backend, this process rank 0, destroyed on exit: collectives return at
    once and move nothing, so one process traces rank 0's step on a mesh of
    the production size (``make_mesh(shape, "cpu")`` over it, DTensors
    holding meta shards). Raises while a process group is live, so it never
    shadows a real world."""
    import torch.distributed as dist
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already live")
    # private API, imported here only: it registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh(shape: Dict[str, int], device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` (axis name -> size: ("data", "model"),
    or ("pod", "data", "model")) over the current world, whose size must
    be the product of the sizes. Ranks fill it row-major: rank =
    (pod · D + data) · M + model."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    names = tuple(shape)
    if names not in (AXES, MULTI_POD_AXES):
        raise ValueError(f"mesh axes {names}: expected {AXES} or "
                         f"{MULTI_POD_AXES}")
    if device_type is None:
        from repro_torch import resolve_device
        device_type = resolve_device(None).type
    sizes = tuple(int(n) for n in shape.values())
    if math.prod(sizes) != dist.get_world_size():
        raise ValueError(f"a mesh of {dict(shape)} needs {math.prod(sizes)} "
                         f"ranks; the world has {dist.get_world_size()}")
    return init_device_mesh(device_type, sizes, mesh_dim_names=names)


def production_hints(model, mesh, batch_size: int) -> Dict[str, Any]:
    """The activation hints the reference's launcher and dry-run set: the
    batch over the fsdp axes when it divides them (``"btd"``); for MoE one
    token group a data shard (``"moe_groups"``) and, for an MoE whose
    experts do not divide the fsdp axes (grok-1), the ZeRO-3 weight hints
    the reference forces there, which name what ``gather_at_use`` does to
    every weight here. On a ``DeviceMesh`` whose "model" axis is larger
    than 1, ``"model"`` names the mesh whose "model" group the model code's
    tensor-parallel collectives run on (``sharding.model_axis``); without
    it the model code is the plain path."""
    from repro_torch.distributed.sharding import (NamedSharding, _fits,
                                                  axis_sizes, fsdp_axes)
    dp = fsdp_axes(mesh)
    bspec = dp if _fits(mesh, batch_size, dp) else None
    hints: Dict[str, Any] = {"btd": NamedSharding(mesh, (bspec, None, None))}
    if hasattr(mesh, "get_group") and axis_sizes(mesh)["model"] > 1:
        hints["model"] = mesh
    if model.cfg.has_moe:
        hints["moe_groups"] = math.prod(axis_sizes(mesh)[a] for a in dp)
        hints["moe_tokens"] = NamedSharding(mesh, (bspec, None, None))
        if not _fits(mesh, model.cfg.moe.num_experts, dp):
            hints["moe_w_col"] = NamedSharding(mesh, (None, None, "model"))
            hints["moe_w_row"] = NamedSharding(mesh, (None, "model", None))
            hints["moe_buf"] = NamedSharding(mesh, (dp, None, None, None))
    return hints


def production_state(model, params: Any, mesh, batch_size: int):
    """Params and optimizer state placed on ``mesh`` by the sharding rules
    (``sharding.distribute``: meta params become DTensors of meta shards),
    and ``production_hints``. Returns (params, opt_state, hints)."""
    from repro_torch.distributed.sharding import (distribute,
                                                  opt_state_shardings,
                                                  param_shardings)
    from repro_torch.training.optimizer import OptState, init_opt_state
    p_sh = param_shardings(model, mesh)
    opt_sh = opt_state_shardings(p_sh, mesh)
    opt = init_opt_state(params)
    opt = OptState(step=opt.step, mu=distribute(opt.mu, opt_sh.mu),
                   nu=distribute(opt.nu, opt_sh.nu))
    params = distribute(params, p_sh)
    return params, opt, production_hints(model, mesh, batch_size)


def make_host_mesh(device_type: Optional[str] = None, *,
                   multi_pod: bool = False):
    """A (1, 1) ``DeviceMesh`` named ("data", "model") — (1, 1, 1) with
    "pod" first when ``multi_pod`` — over the current world, which must be
    one process (a world of 1 is started if none exists).
    ``device_type`` defaults to ``cuda``, and raises without a GPU like
    every entry point of the port."""
    if device_type is None:
        from repro_torch import resolve_device
        device_type = resolve_device(None).type
    ensure_process_group(device_type)
    names = MULTI_POD_AXES if multi_pod else AXES
    return make_mesh(dict.fromkeys(names, 1), device_type)


__all__ = ["AXES", "MULTI_POD_AXES", "MeshShape", "ensure_process_group",
           "fake_world",
           "make_host_mesh", "make_mesh", "make_production_mesh",
           "production_hints", "production_state", "rank_device"]
