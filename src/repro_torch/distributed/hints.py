"""Activation-sharding hints: the counterpart of the JAX package's
``distributed/hints.py``.

The reference pins activation layouts with ``with_sharding_constraint`` at
block boundaries, inside an optional context, so model code stays
mesh-agnostic. Here the context holds ``NamedSharding`` values
(``distributed/sharding.py``: a mesh and a spec). ``constrain`` is a no-op
outside the context, for a kind the context does not name, and for a plain
tensor; given a DTensor inside it, it redistributes the DTensor to the
hint's placements. The port's training step keeps activations as plain
tensors and gathers each weight at use (``sharding.gather_at_use``, a
layer's inside the layer's body), so on
that path the calls sit where the reference puts them (``_decoder_input``,
``stack_full``, ``_chunked_ce``) and leave the tensors as they are. There
the ``"btd"`` hint also says which mesh axes split the batch: a plain
activation is this rank's block over them (``sharding.batch_axes``), and
the ``"model"`` hint names the mesh whose "model" group the model code's
tensor-parallel collectives run on (``sharding.model_axis``; without it,
the plain path). The MoE experts a rank holds a block of are sharded over
the ``"btd"`` hint's axes, whose group the token exchange runs on
(``sharding.expert_block``).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Optional

import torch

_STATE = threading.local()


def _current() -> Optional[Dict[str, object]]:
    return getattr(_STATE, "specs", None)


@contextlib.contextmanager
def activation_sharding(specs: Dict[str, object]):
    """specs: kind -> ``NamedSharding`` (e.g. ``{"btd": NamedSharding(mesh,
    (dp, None, None))}``), or a non-tensor hint such as ``"moe_groups"``."""
    prev = _current()
    _STATE.specs = specs
    try:
        yield
    finally:
        _STATE.specs = prev


def carry(fn: Callable) -> Callable:
    """``fn`` run under the hints current at this call. A non-reentrant
    checkpoint recomputes its body in the backward pass, and on CUDA the
    backward runs on the autograd engine's own thread, where the hints of
    the thread that ran the forward are not set: a checkpointed body that
    reads them (``moe_ffn``'s groups, ``moe.route``'s aux all-reduce)
    carries them there, so the recompute is the forward."""
    specs = _current()

    def run(*args):
        with activation_sharding(specs):
            return fn(*args)

    return run


def constrain(x: torch.Tensor, kind: str) -> torch.Tensor:
    specs = _current()
    if specs is None or kind not in specs:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    sharding = specs[kind]
    return x.redistribute(sharding.mesh, sharding.placements)


def static_hint(kind: str, default=None):
    """Non-tensor hints (e.g. 'moe_groups': the data-shard count the MoE
    dispatch should group by), stored in the same context dict."""
    specs = _current()
    if specs is None:
        return default
    return specs.get(kind, default)


__all__ = ["activation_sharding", "carry", "constrain", "static_hint"]
