"""Carry weights across from the JAX package to this one.

``torch`` cannot reproduce ``jax.random`` initialisation, so a parity test
makes its weights once, in the JAX package, and hands them over: the caller
turns the JAX parameter tree into nested dicts of numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``) and ``params_from_numpy``
returns the same tree as tensors on a device. The layout is kept exactly:
per-layer weights stay stacked on a leading ``[L, ...]`` axis, and every
key keeps its name. This module imports no jax.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device

_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "int32": torch.int32,
           "int64": torch.int64, "int8": torch.int8, "bool": torch.bool}


def tensor_from_numpy(arr: np.ndarray, device: torch.device
                      ) -> torch.Tensor:
    """One array to a tensor on ``device``, bit for bit. numpy has no
    bfloat16 of its own; a bfloat16 array (``ml_dtypes``) is widened to
    float32, which is exact, and narrowed back on the torch side."""
    name = np.dtype(arr.dtype).name
    if name not in _DTYPES:
        raise TypeError(f"no torch dtype for numpy dtype {name!r}")
    # a private, writable copy (arrays from a JAX tree are read-only views)
    src = np.array(arr, dtype=np.float32 if name == "bfloat16" else None)
    t = torch.from_numpy(src).to(device=device)
    return t.to(_DTYPES[name])


def params_from_numpy(tree: Mapping[str, Any], device: DeviceLike = None
                      ) -> dict:
    """The JAX package's parameter tree (nested dicts of numpy arrays) as
    the same tree of tensors, same dtypes, on ``device``."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, Mapping):
            return {k: conv(v) for k, v in node.items()}
        return tensor_from_numpy(np.asarray(node), dev)

    return conv(tree)


__all__ = ["params_from_numpy", "tensor_from_numpy"]
