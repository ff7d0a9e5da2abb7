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
(``rank_device``).
"""
from __future__ import annotations

import dataclasses
import math
import os
from datetime import timedelta
from typing import Dict, Optional, Tuple

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
           "make_host_mesh", "make_mesh", "make_production_mesh",
           "rank_device"]
