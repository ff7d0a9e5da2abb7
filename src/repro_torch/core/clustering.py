"""GEMM shape clustering (paper Fig. 7).

The paper's observation: matrix-multiply problems across production DNNs
concentrate into a small number of (n, k) clusters, so cross-stream problems
can be coalesced into superkernels with minimal padding. We cluster in
log-space over (n, k) — the weight dims, which must match exactly or pad —
and keep m (the token/batch dim) free, because the coalesced kernel
concatenates problems along m.

Two levels:
  * ``exact_key``      — problems coalescible with ZERO padding (same n, k);
  * ``cluster_greedy`` — agglomerative log-space clustering with a padding-
    waste bound, reproducing the A/B/C superkernel clusters of Fig. 7.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

from repro_torch.core.costmodel import GemmShape
from repro_torch.core.kernelspec import KernelOp


def exact_key(shape: GemmShape) -> Tuple[int, int, int]:
    return (shape.n, shape.k, shape.dtype_bytes)


@dataclasses.dataclass
class Cluster:
    """A set of problems padded to a common (n, k) envelope."""

    members: List[GemmShape]

    @property
    def pad_n(self) -> int:
        return max(s.n for s in self.members)

    @property
    def pad_k(self) -> int:
        return max(s.k for s in self.members)

    @property
    def useful_flops(self) -> float:
        return sum(s.flops for s in self.members)

    @property
    def padded_flops(self) -> float:
        n, k = self.pad_n, self.pad_k
        return sum(2.0 * s.m * n * k * s.layers for s in self.members)

    @property
    def padding_waste(self) -> float:
        """Fraction of superkernel flops burned on padding (0 = perfect)."""
        pf = self.padded_flops
        return 0.0 if pf == 0 else 1.0 - self.useful_flops / pf


def _log_dist(a: GemmShape, b: GemmShape) -> float:
    return math.hypot(math.log2(a.n) - math.log2(b.n),
                      math.log2(a.k) - math.log2(b.k))


def cluster_greedy(shapes: Sequence[GemmShape], max_waste: float = 0.25
                   ) -> List[Cluster]:
    """Greedy agglomerative clustering under a padding-waste bound.

    Problems are sorted by (n, k) volume and greedily absorbed into the
    nearest existing cluster if the merged padding waste stays below
    ``max_waste``; otherwise they seed a new cluster. Deterministic and
    O(S·C) — the populations involved are small (paper §5.3: 'the set of
    operations to coalesce is restricted largely to algebraic tensor ops').
    """
    clusters: List[Cluster] = []
    for s in sorted(shapes, key=lambda s: (s.n * s.k, s.n, s.k), reverse=True):
        best, best_d = None, float("inf")
        for c in clusters:
            trial = Cluster(c.members + [s])
            if trial.padding_waste <= max_waste:
                d = _log_dist(s, c.members[0])
                if d < best_d:
                    best, best_d = c, d
        if best is None:
            clusters.append(Cluster([s]))
        else:
            best.members.append(s)
    return clusters


# ---------------------------------------------------------------------------
# weight-key schema — the operand-identity layer of the coalescing space
# ---------------------------------------------------------------------------
# Coalescing ELIGIBILITY is (n, k, dtype) only — or the full stack signature
# for layer-stacked ops — but two finer identities ride on the ops and
# matter to the dispatch layer:
#   * the weight KEY (op.payload[2], attached by JitSession._push_op): ops
#     sharing one key literally serve the same weight array(s), so the whole
#     group collapses to a single weight load (the shared-operand regime);
#   * the EXPERT tag prefix: MoE tenants emit each expert FFN GEMM as its
#     own stage tagged "expert_*" with the expert index in the weight key,
#     so the same expert's GEMMs coalesce across tenants (and with dense
#     FFN GEMMs sharing their (n, k)) — the scenario-diversity win counted
#     by JitStats.expert_coalesced.
#
# ``weight_key`` below is THE single key constructor (used by core/jit.py
# builders and core/dispatch.py matvec): the schema used to be rebuilt
# ad-hoc at each emission site with the layer index assumed at a fixed
# tuple position, which would have silently broken shared-operand detection
# the moment stacked keys (no per-layer index) appeared. The shapes are:
#
#   per-layer operand   (model, pid, layer:int, name[, expert])
#   stacked operand     (model, pid, "stack", lo, hi, name[, expert])
#   model-level operand (model, pid, name)            e.g. "unembed"
#   raw matvec          ("matvec"|"matvec-shared", id(w))
#
# The "stack" marker cannot collide with the other forms at position 2:
# per-layer keys hold an int there and model-level keys hold an operand
# name, which is never the reserved string "stack".

EXPERT_TAG_PREFIX = "expert_"


def weight_key(model_name: str, params_id: int, name: str, *,
               layer=None, expert=None, stack=None) -> Tuple:
    """Build an operand-identity key (single schema for all emitters).

    ``stack=(lo, hi)`` names one stacked operand covering layers
    [lo, hi) — one key per homogeneous sub-stack, layer index dropped.
    ``layer`` names a per-layer slice (the stacked_layers=False oracle
    path). Neither → a model-level operand (tied unembed etc.).
    ``expert`` appends the MoE expert index in either regime.
    """
    if stack is not None:
        lo, hi = stack
        key: Tuple = (model_name, params_id, "stack", int(lo), int(hi), name)
    elif layer is not None:
        key = (model_name, params_id, int(layer), name)
    else:
        key = (model_name, params_id, name)
    if expert is not None:
        key = key + (int(expert),)
    return key


def matvec_weight_key(w, shared: bool = False) -> Tuple:
    """Identity key for a raw (non-program) matvec weight array."""
    return ("matvec-shared" if shared else "matvec", id(w))


def op_weight_key(op: KernelOp):
    """The op's operand-identity key, or None for raw (payload-free) ops."""
    return op.payload[2] if op.payload is not None else None


def shared_weight_key(ops: Sequence[KernelOp]):
    """The single weight key every op of the group carries — the condition
    for the shared-operand dispatch regime (one weight load serves the
    whole group) — or None (incl. singleton groups and raw op streams)."""
    if len(ops) < 2:
        return None
    key = op_weight_key(ops[0])
    if key is None:
        return None
    return key if all(op_weight_key(op) == key for op in ops[1:]) else None


def op_weight_identity(op: KernelOp):
    """Identity (ids) of the array(s) the op's weight binding resolved to,
    or None when nothing is bound yet.

    This is what the shared-operand LEGALITY check compares: equal weight
    *keys* are supposed to imply the identical weight *array* (one load
    serves the group), and the schedule certifier verifies that
    implication on every shared dispatch instead of trusting it. Plain ops
    carry their weight in ``payload[1]``; stacked ops bind lazily, so
    their identity is the tuple of operand-guard array ids the session
    attaches in ``payload[1]`` (see JitSession._push_stacked_op)."""
    if op.payload is None:
        return None
    w = op.payload[1]
    if w is None:
        return None
    return tuple(id(a) for a in w) if isinstance(w, tuple) else (id(w),)


def is_expert_op(op: KernelOp) -> bool:
    """True for a per-expert MoE FFN GEMM (tag "expert_gate/up/down"),
    or for a stacked layer body that carries expert operands."""
    if op.tag.startswith(EXPERT_TAG_PREFIX):
        return True
    return op.stack is not None and any(
        tag.startswith(EXPERT_TAG_PREFIX) for tag, _ in op.stack)


def coalesce_key(op: KernelOp) -> Tuple:
    """The op's zero-padding coalescing bucket.

    Plain ops bucket on (n, k, dtype) — m stays free (problems concatenate
    along m). A layer-stacked op buckets on its FULL stack signature: the
    ordered (tag, layers, n, k, dtype) tuple of every operand in the
    scanned body, m again free — so two tenants of the same depth-and-dims
    config coalesce their *entire stacks* in one group, while differing
    depths or operand sets (which could not share one scan) never mix.
    The leading "stack" marker keeps stacked buckets disjoint from plain
    (n, k, dtype) triples.

    The op's DEVICE placement leads every key: coalescing is a per-device
    act (one superkernel launches on one device), so ops assigned to
    different devices must never share a bucket — enforced structurally
    here rather than by a scheduler-side filter, and double-checked by the
    schedule certifier's PlacementHazard. Single-device runs put device=0
    everywhere, so the grouping is unchanged.
    """
    if op.stack is not None:
        return ("stack", op.device) + tuple(
            (tag, s.layers, s.n, s.k, s.dtype_bytes) for tag, s in op.stack)
    return (op.device,) + exact_key(op.shape)


def group_ops_exact(ops: Sequence[KernelOp]) -> Dict[Tuple, List[KernelOp]]:
    """Bucket ready ops by zero-padding coalescing key (``coalesce_key``:
    exact n, k, dtype — or the full stack signature for stacked ops).

    The m (token/row) dimension — and with it the gemv/gemm aspect and the
    decode/prefill phase — is deliberately NOT part of the key: coalesced
    superkernels concatenate problems along m, so a tall prompt-prefill GEMM
    packs with decode GEMVs that share its weight dims. Splitting on aspect
    used to keep prefill traffic out of every decode group, serializing
    exactly the large under-filled kernels the paper overlaps.
    """
    groups: Dict[Tuple, List[KernelOp]] = {}
    for op in ops:
        key = coalesce_key(op)
        groups.setdefault(key, []).append(op)
    return groups
