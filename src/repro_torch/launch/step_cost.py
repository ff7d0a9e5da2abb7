"""Per-chip step accounting by tracing: the counterpart of the JAX
package's ``launch/hlo_parse.py`` (and of ``hlo_analysis.collective_bytes``).

The reference compiles a step and reads its optimized HLO. The port runs
eagerly, so it counts the step as it runs: ``StepCounter`` is a
``TorchDispatchMode`` that sees every ATen op and every collective of one
rank, on meta tensors (the dry-run, no allocation) as on CUDA tensors. On a
DTensor op it steps aside (returns ``NotImplemented``), so DTensor desugars
the op into the rank's local ops and its collectives, which come back
through the mode: every number is per chip, as the reference's per-device
SPMD module gives it.

  * ``flops``: dot FLOPs, 2 × output elements × contraction size of every
    product (``mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` / ``mv`` / ``dot``),
    as ``hlo_parse._dot_flops``; convolutions and fused attention through
    ``torch.utils.flop_counter``'s registry.
  * ``bytes``: the input and output bytes of every op that moves data; views,
    ``detach`` and allocations without a write count nothing. Eager PyTorch
    fuses nothing, so this is the step's eager traffic: an upper bound on
    the reference's fusion-aware count, not that count.
  * ``collective_bytes`` / ``per_collective``: the operand bytes of every
    ``_c10d_functional`` / ``c10d`` collective (DTensor's redistributions,
    ``dist.all_reduce``, the MoE token exchange's
    ``dist.all_to_all_single``), by the
    reference's five kinds (``COLLECTIVE_OPS``). A collective of another
    kind raises: no record leaves a term out.
  * ``memory``: the step's arguments plus every storage it allocates, each
    freed when it dies (autograd's saved tensors keep theirs); ``peak_bytes``
    is the most held at once, the counterpart of XLA's
    ``memory_analysis().peak_memory_in_bytes``.

XLA's ``cost_analysis`` counts a while body once, hence the reference's
trip-count logic; eager execution runs every layer and every remat
recompute, so each is counted as it runs and loops cost nothing extra.
"""
from __future__ import annotations

import dataclasses
import gc
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed.sharding import local
from repro_torch.tree import leaves

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute")

_aten = torch.ops.aten
# products: 2 × output elements × the contraction size, the last dimension
# of the first matrix operand (the argument at the index given)
_PRODUCTS = {_aten.mm: 0, _aten.bmm: 0, _aten.mv: 0, _aten.dot: 0,
             _aten.addmm: 1, _aten.baddbmm: 1}
# ops that move no data: allocations without a write, aliases
_FREE = {_aten.detach, _aten.alias, _aten.lift_fresh, _aten.empty,
         _aten.empty_like, _aten.empty_strided, _aten.new_empty,
         _aten.new_empty_strided}

# collectives by (namespace, op name): (kind, the argument holding the
# operands; None: a receive, whose operand is its sender's)
_COLLECTIVES: Dict[Tuple[str, str], Tuple[str, Optional[int]]] = {}
for _ns in ("_c10d_functional", "_c10d_functional_autograd"):
    _COLLECTIVES.update({
        (_ns, "all_gather_into_tensor"): ("all-gather", 0),
        (_ns, "all_gather_into_tensor_out"): ("all-gather", 0),
        (_ns, "all_gather_into_tensor_coalesced"): ("all-gather", 0),
        (_ns, "reduce_scatter_tensor"): ("reduce-scatter", 0),
        (_ns, "reduce_scatter_tensor_coalesced"): ("reduce-scatter", 0),
        (_ns, "all_reduce"): ("all-reduce", 0),
        (_ns, "all_reduce_"): ("all-reduce", 0),
        (_ns, "all_reduce_coalesced"): ("all-reduce", 0),
        (_ns, "all_reduce_coalesced_"): ("all-reduce", 0),
        (_ns, "all_to_all_single"): ("all-to-all", 0),
    })
_COLLECTIVES.update({
    ("c10d", "allreduce_"): ("all-reduce", 0),
    ("c10d", "allreduce_coalesced_"): ("all-reduce", 0),
    ("c10d", "allgather_"): ("all-gather", 1),
    ("c10d", "_allgather_base_"): ("all-gather", 1),
    ("c10d", "allgather_into_tensor_coalesced_"): ("all-gather", 1),
    ("c10d", "reduce_scatter_"): ("reduce-scatter", 1),
    ("c10d", "_reduce_scatter_base_"): ("reduce-scatter", 1),
    ("c10d", "reduce_scatter_tensor_coalesced_"): ("reduce-scatter", 1),
    ("c10d", "alltoall_"): ("all-to-all", 1),
    ("c10d", "alltoall_base_"): ("all-to-all", 1),
    ("c10d", "send"): ("collective-permute", 0),
    ("c10d", "recv_"): ("collective-permute", None),
})
# bookkeeping of the functional collectives: no data moves
_COMM_FREE = {("_c10d_functional", "wait_tensor"),
              ("_c10d_functional", "_wrap_tensor_autograd")}
_COMM_NAMESPACES = {"_c10d_functional", "_c10d_functional_autograd", "c10d"}


@dataclasses.dataclass
class CostTotals:
    """Per-chip totals of one traced step (``hlo_parse.CostTotals``)."""
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    per_collective: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_OPS})


def _tensors(tree: Any):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """Counts one rank's dot FLOPs, bytes, collective bytes and live
    storage on ``device`` (module doc). Tensors on other devices (a CPU
    scalar in a CUDA step) are not counted."""

    def __init__(self, device: torch.device):
        super().__init__()
        self.device_type = torch.device(device).type
        self.totals = CostTotals()
        self.live_bytes = 0
        self.peak_bytes = 0
        self.argument_bytes = 0
        self._seen: "weakref.WeakKeyDictionary[Any, int]" = \
            weakref.WeakKeyDictionary()

    # -- storage accounting ------------------------------------------------
    def _on_device(self, t: torch.Tensor) -> bool:
        return t.device.type == self.device_type

    def _hold(self, t: torch.Tensor) -> bool:
        """Count ``t``'s storage live if it is new; whether it was."""
        st = t.untyped_storage()
        if st in self._seen:
            return False
        n = st.nbytes()
        self._seen[st] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, n).atexit = False
        return True

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def hold_arguments(self, tree: Any) -> None:
        """The step's arguments (a DTensor's local shard): live from the
        start, counted in ``argument_bytes``."""
        for t in leaves(tree):
            if isinstance(t, torch.Tensor):
                t = local(t)
                if self._on_device(t) and self._hold(t):
                    self.argument_bytes += t.untyped_storage().nbytes()

    # -- dispatch ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            # DTensor desugars the op into local ops and collectives, which
            # come back through this mode
            return NotImplemented
        kwargs = kwargs or {}
        tot = self.totals
        key = (func.namespace, func._opname)
        free = key in _COMM_FREE or func._overloadpacket in _FREE \
            or func.is_view
        if func.namespace in _COMM_NAMESPACES and not free:
            if key not in _COLLECTIVES:
                raise NotImplementedError(
                    f"step_cost: collective {func} is none of the five "
                    f"kinds {COLLECTIVE_OPS}")
            kind, at = _COLLECTIVES[key]
            b = 0 if at is None else sum(_nbytes(t)
                                         for t in _tensors(args[at]))
            tot.collective_bytes += b
            tot.per_collective[kind] += b
        ins = [t for t in _tensors((args, kwargs)) if self._on_device(t)]
        for t in ins:
            # read but allocated where this mode does not see it (a table
            # made before the step)
            self._hold(t)
        out = func(*args, **kwargs)
        outs = [t for t in _tensors(out) if self._on_device(t)]
        for t in outs:
            self._hold(t)
        pk = func._overloadpacket
        if pk in _PRODUCTS:
            lhs = args[_PRODUCTS[pk]]
            tot.flops += 2 * out.numel() * lhs.shape[-1]
        elif pk in flop_registry:
            tot.flops += flop_registry[pk](*args, **kwargs, out_val=out)
        if not free:
            tot.bytes += sum(_nbytes(t) for t in ins + outs)
        return out


def count_step(fn: Callable[..., Any], *args: Any
               ) -> Tuple[Any, CostTotals, Dict[str, int]]:
    """Run ``fn(*args)`` under a ``StepCounter`` on the device of the first
    tensor in ``args``; return (its result, the totals, the memory:
    ``argument_bytes`` (the arguments' storages), ``output_bytes`` (the
    result's distinct storages), ``temp_bytes`` (the peak less the
    arguments), ``peak_bytes``)."""
    first = next(t for t in leaves(args) if isinstance(t, torch.Tensor))
    # storages held only by earlier cycles die now, and the collector's
    # counts start from zero: the peak does not hang on what ran before
    gc.collect()
    counter = StepCounter(local(first).device)
    counter.hold_arguments(args)
    with counter:
        result = fn(*args)
    outs = {}
    for t in leaves(result):
        if isinstance(t, torch.Tensor) and counter._on_device(local(t)):
            st = local(t).untyped_storage()
            outs[id(st)] = st.nbytes()
    memory = {"argument_bytes": counter.argument_bytes,
              "output_bytes": sum(outs.values()),
              "temp_bytes": counter.peak_bytes - counter.argument_bytes,
              "peak_bytes": counter.peak_bytes}
    return result, counter.totals, memory


__all__ = ["COLLECTIVE_OPS", "CostTotals", "StepCounter", "count_step"]
