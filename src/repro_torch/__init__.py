"""PyTorch/CUDA port of the OoO VLIW JIT for multi-tenant inference.

A second package beside the JAX package ``repro``: the same modules under
the same names, with the Pallas TPU kernels replaced by kernels written by
hand for NVIDIA Hopper. It imports ``torch``, ``numpy`` and the standard
library only.

Entry points (``Model``, ``ServingEngine``, ``launch/serve.py``) run on
``cuda`` unless the caller passes ``device="cpu"``; with no device given
and no GPU present they raise instead of running on the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    current CUDA device. Raises when none is given and CUDA is absent."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            # "cuda" and "cuda:0" name one card; compare them as one
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions "
            "on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


__all__ = ["DeviceLike", "resolve_device"]
