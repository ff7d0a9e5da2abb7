"""Checkpointing to flat ``.npz`` archives with the JAX package's key
scheme, so a checkpoint written by either package restores in the other.

Leaves are keyed by their tree path joined with ``/`` in JAX's flatten
order (``repro_torch/tree.py``): ``params/blocks/attn/wq``,
``opt/step``, ``opt/mu/...``, ``opt/nu/...``, and ``__step__`` for the
step argument. Restore rebuilds the tree against a reference structure
(shapes must match) and casts each array to the reference leaf's dtype.

bfloat16, which numpy lacks: the reference writes ``ml_dtypes.bfloat16``
arrays, which numpy without ``ml_dtypes`` loads as two-byte voids
(``|V2``); this module reads those bytes as bf16 bits. It writes a bf16
leaf widened to fp32, which is exact, so the reference's ``astype``
restores it bit for bit. A DTensor leaf is gathered before it is written:
every rank of the world takes part in the gathers (each is a collective),
rank 0 alone writes the file, and the ranks return once it is written.
``shardings`` places restored leaves on a ``DeviceMesh``.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import DeviceLike
from repro_torch.distributed.sharding import full
from repro_torch.tree import flatten_with_path, map_with_path, path_key


def _to_numpy(leaf: Any) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = full(leaf).detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()                       # exact; see the module doc
    return t.numpy()


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        # an ml_dtypes bfloat16 array, loaded without ml_dtypes
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def save_checkpoint(path: str, tree: Any, step: Optional[int] = None) -> str:
    """Write ``tree`` to ``path``; called by every rank of a world."""
    import torch.distributed as dist
    payload = {path_key(p): _to_numpy(leaf)
               for p, leaf in flatten_with_path(tree)}
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world == 1 or dist.get_rank() == 0:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if step is not None:
            payload["__step__"] = np.asarray(step)
        tmp = path + ".tmp"
        np.savez(tmp, **payload)
        os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)
    if world > 1:
        dist.barrier()
    return path


def restore_checkpoint(path: str, reference: Any,
                       shardings: Optional[Any] = None,
                       device: DeviceLike = None) -> Any:
    """Restore into the structure of ``reference`` (a tree of tensors,
    meta ones included; shapes must match), each leaf in the reference
    leaf's dtype on ``device`` (default: the reference leaf's device; a
    meta reference needs ``device``). ``shardings``: an optional tree of
    ``NamedSharding`` (same structure) to place each leaf as a DTensor."""
    with np.load(path) as data:
        def restore(p, ref):
            key = path_key(p)
            arr = data[key]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape}, "
                                 f"reference {tuple(ref.shape)}")
            dev = device if device is not None else ref.device
            if torch.device(dev).type == "meta":
                raise ValueError("a meta reference needs device=")
            return _to_tensor(arr).to(device=dev, dtype=ref.dtype)

        tree = map_with_path(restore, reference)
    if shardings is not None:
        from repro_torch.distributed.sharding import distribute
        tree = distribute(tree, shardings)
    return tree


def checkpoint_step(path: str) -> Optional[int]:
    with np.load(path) as data:
        if "__step__" in data:
            return int(data["__step__"])
    return None


__all__ = ["checkpoint_step", "restore_checkpoint", "save_checkpoint"]
