"""Meshes: the counterpart of the JAX package's ``launch/mesh.py``.

Defined as FUNCTIONS, not module constants, so importing this module
touches no device and starts no process group.

``make_production_mesh`` DESCRIBES the reference's production meshes (16 ×
16 chips a pod; 2 × 16 × 16 across two pods) by axis name and size: the
sharding rules and the dry-run read only those sizes, and no host holds
256 cards. ``make_host_mesh`` is a real ``DeviceMesh`` of shape (1, 1)
with the production axis names over the current world of one process; if
no process group exists it starts one of world size 1 on an in-memory
store (no TCP rendezvous).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple


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


def ensure_process_group(device_type: str) -> bool:
    """Start a world-size-1 process group (nccl for ``cuda``, gloo
    otherwise) on an in-memory store unless one exists. Returns whether it
    started one (the caller then destroys it)."""
    import torch.distributed as dist
    if dist.is_initialized():
        return False
    backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    return True


def make_host_mesh(device_type: Optional[str] = None, *,
                   multi_pod: bool = False):
    """A (1, 1) ``DeviceMesh`` named ("data", "model") — (1, 1, 1) with
    "pod" first when ``multi_pod`` — over the current world, which must be
    one process. ``device_type`` defaults to ``cuda``, and raises without
    a GPU like every entry point of the port."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if device_type is None:
        from repro_torch import resolve_device
        device_type = resolve_device(None).type
    ensure_process_group(device_type)
    if dist.get_world_size() != 1:
        raise ValueError(f"the host mesh is one process; the world has "
                         f"{dist.get_world_size()}")
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, (1,) * len(names),
                            mesh_dim_names=names)


__all__ = ["MeshShape", "ensure_process_group", "make_host_mesh",
           "make_production_mesh"]
