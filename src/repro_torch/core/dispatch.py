"""Superkernel dispatch fast path — the steady-state execution layer.

Replaces the JAX package's ``core/dispatch.py``. Its jitted dispatch bodies
wrapped the Pallas TPU kernel ``coalesced_gemm``; here ``_dispatch_grouped``
and ``_dispatch_shared`` are plain functions around the hand-written CUDA
kernel ``repro_torch.kernels.coalesced_gemm`` (its plain PyTorch version on
CPU tensors).

The eager path (kernels/ops.py ``execute_superkernel``) re-pads and
``torch.stack``s the full weight matrices of the group on every dispatch.
``SuperkernelExecutor`` (owned by ``VLIWJit``, surviving sessions like the
plan caches) avoids that:

  * **persistent packed-weight cache** — the padded/stacked weight operand
    of a group is cached in a ``PlanCache`` keyed by the group's ordered
    weight-key tuple + bucketed envelope, identity-guarded on the weight
    tensors themselves. Steady-state ticks re-send ZERO weight bytes
    (``DispatchStats.bytes_not_copied`` counts the traffic avoided).
  * **shape-bucketed superkernels** — per-problem rows go to ``bm``
    multiples with the total m-tile count a power of two, K and N to
    128-floored powers of two (``kernels/ops.envelope_bucket``), and the
    problem count G to an unfloored power of two (``_pow2``).
  * **layer-stacked operands** — ``stacked_operand`` caches one padded
    [L, K, N] tensor per operand of a layer body (core/jit.py
    ``StackedGemmStage``), guarded on the original stacked params tensor;
    the body launches the kernel on one layer of it at a time.

Identity-guard rule for torch tensors: the guard compares with ``is``, so
it must be handed the ORIGINAL weight tensors — the same objects on every
tick. ``w.T``, ``w[l]`` and ``w.contiguous()`` each return a new object,
so a weight function that builds one per call reads as a hot-swap on every
tick and repacks (core/jit.py memoizes its per-layer views and the tied
unembed transpose for this reason). A weight hot-swap REPLACES the tensors
(a new params tree); it never mutates them in place. ``w.copy_(new)`` keeps
the tensor's identity, the guard cannot see it, and the cache would go on
serving the old packed copy.

``matvec`` is the paper's §5.3 RNN/LSTM regime: G matvecs, one vector per
stream. G streams on ONE weight tensor go through the shared-operand GEMM
path; distinct weights are stacked into a cached [G_pad, K, N] operand and
run by the hand-written ``coalesced_gemv`` kernel (``_dispatch_matvec``).

``DispatchStats.retraces`` counted jitted-body traces in the JAX package.
Eager PyTorch has nothing to retrace; the field now counts kernel library
builds during the dispatch (``kernels.build.build_count``, over all
kernels): one per library on its first CUDA dispatch in a process, 0 after
it and 0 on the CPU.

Correctness contract: bucket padding is zeros, and adding ``+0.0`` terms to
an fp32 accumulator is exact, so the bucketed fast path computes the same
sums as the eager exact-envelope path up to the kernel's summation order.

Memory note: cached packed weights are full padded copies, bounded in
BYTES by ``VLIWJit(weight_budget_bytes=...)`` (default 1 GiB).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.clustering import matvec_weight_key
from repro_torch.core.kernelspec import KernelOp
from repro_torch.core.plancache import PlanCache
from repro_torch.core.schedtrace import OperandIdentityHazard
from repro_torch.kernels.build import build_count
from repro_torch.kernels.coalesced_gemm import coalesced_gemm
from repro_torch.kernels.coalesced_gemv import coalesced_gemv
from repro_torch.kernels.ops import _round_up, envelope_bucket


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DispatchStats:
    """Counters for the dispatch fast path. Supports ``+``/``-`` so
    per-session deltas fold through ``JitStats.merge`` like every other
    counter."""

    dispatches: int = 0
    weight_hits: int = 0           # packed-weight operand served from cache
    weight_misses: int = 0         # packed/stacked + staged this dispatch
    weight_invalidations: int = 0  # identity-guard trips (weight hot-swap)
    retraces: int = 0              # kernel library builds (see docstring)
    bytes_not_copied: int = 0      # packed-weight bytes NOT re-staged (hits)

    @property
    def weight_hit_rate(self) -> float:
        n = self.weight_hits + self.weight_misses
        return self.weight_hits / n if n else 0.0

    def copy(self) -> "DispatchStats":
        return dataclasses.replace(self)

    def _combine(self, other: "DispatchStats", sign: int) -> "DispatchStats":
        return DispatchStats(
            *(getattr(self, f.name) + sign * getattr(other, f.name)
              for f in dataclasses.fields(self)))

    def __add__(self, other: "DispatchStats") -> "DispatchStats":
        return self._combine(other, +1)

    def __sub__(self, other: "DispatchStats") -> "DispatchStats":
        return self._combine(other, -1)


# ---------------------------------------------------------------------------
# the dispatch bodies: pack -> kernel -> unpack
# ---------------------------------------------------------------------------

def _pad_rows_cols(a: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return F.pad(a, (0, cols - int(a.shape[1]), 0, rows - int(a.shape[0])))


def _dispatch_grouped(activations, b_stacked, group_ids, *, n_real, m_tiles,
                      bm) -> Tuple[torch.Tensor, ...]:
    """pack → grouped GEMM → unpack.

    activations: tuple of [m_i, k_i] (k_i ≤ K); b_stacked: [G_pad, K, N];
    group_ids: [m_tiles] int32 (pad tiles point at group 0 — their zero
    activation rows produce zero output rows, sliced off below)."""
    K = int(b_stacked.shape[1])
    parts = [_pad_rows_cols(a, _round_up(int(a.shape[0]), bm), K)
             for a in activations]
    a_packed = torch.cat(parts, dim=0)
    a_packed = _pad_rows_cols(a_packed, m_tiles * bm, K)
    out = coalesced_gemm(a_packed, b_stacked, group_ids, bm=bm)
    outs, s = [], 0
    for a, n in zip(activations, n_real):
        outs.append(out[s:s + int(a.shape[0]), :n])
        s += _round_up(int(a.shape[0]), bm)
    return tuple(outs)


def _dispatch_shared(activations, b_padded, group_ids, *, n_real, m_tiles,
                     bm) -> Tuple[torch.Tensor, ...]:
    """Shared-operand fast path: all problems use ONE weight matrix —
    activations concatenate into a single GEMM so the weight panel streams
    through the kernel once. group_ids: [m_tiles] int32 zeros."""
    K = int(b_padded.shape[0])
    x = torch.cat(activations, dim=0)
    xp = _pad_rows_cols(x, m_tiles * bm, K)
    out = coalesced_gemm(xp, b_padded[None], group_ids, bm=bm)
    outs, s = [], 0
    for a in activations:
        outs.append(out[s:s + int(a.shape[0]), :n_real])
        s += int(a.shape[0])
    return tuple(outs)


def _dispatch_matvec(xs, w_stacked, *, n_real) -> Tuple[torch.Tensor, ...]:
    """Distinct-weights matvec regime: G_pad vectors against G_pad stacked
    weight panels via ``coalesced_gemv``. The CALLER owns G-bucket padding
    (``matvec`` extends ``xs``/``n_real`` with zero vectors to match
    ``w_stacked``'s leading dim) so exactly one layer decides the bucket."""
    assert len(xs) == int(w_stacked.shape[0]), (len(xs), w_stacked.shape)
    K = int(w_stacked.shape[1])
    xp = torch.stack([F.pad(x, (0, K - int(x.shape[0]))) for x in xs])
    out = coalesced_gemv(xp, w_stacked)
    return tuple(out[i, :n] for i, n in enumerate(n_real))


def _pow2(n: int) -> int:
    """Smallest power of two ≥ n (n ≥ 1)."""
    return 1 << max(n - 1, 0).bit_length()


def _tile_bucket(rows: Sequence[int], bm: int) -> int:
    """Power-of-two m-tile count covering per-problem rows padded to ``bm``
    multiples (``rows`` already concatenated tightly for the shared path is
    handled by passing the single total)."""
    return _pow2(sum(_round_up(m, bm) // bm for m in rows))


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------

class SuperkernelExecutor:
    """Zero-copy steady-state superkernel execution.

    Owned by ``VLIWJit`` (persistent across sessions, like the plan
    caches); ``JitSession.tick`` hands it the planned op group and gets the
    per-problem outputs back.
    """

    def __init__(self, weight_cache: Optional[PlanCache] = None, *,
                 bm: int = 8):
        assert bm & (bm - 1) == 0, f"bm must be a power of two, got {bm}"
        # packed-weight entries are full padded copies, so the fallback
        # cache is byte-budgeted too
        self.weight_cache = weight_cache if weight_cache is not None \
            else PlanCache(256, byte_capacity=1 << 30)
        # the packer's m-tile; the CUDA kernel tiles N and K itself
        self.bm = bm
        self.stats = DispatchStats()
        # device copies of group-id vectors, one per distinct (pattern,
        # device): building one from a host list is a blocking copy, and
        # bucketing keeps the set of patterns small
        self._gids: Dict[Tuple, torch.Tensor] = {}

    def group_ids(self, gids: Tuple[int, ...],
                  device: torch.device) -> torch.Tensor:
        """The device copy of a group-id vector, built once per pattern."""
        key = (gids, str(device))
        t = self._gids.get(key)
        if t is None:
            t = self._gids[key] = torch.tensor(gids, dtype=torch.int32,
                                               device=device)
        return t

    # ------------------------------------------------------------------
    def _packed_weights(self, weights: Sequence[torch.Tensor],
                        wkeys: Sequence[Tuple], K: int, N: int, G_pad: int,
                        *, shared: bool, group=None,
                        device: int = 0) -> torch.Tensor:
        """The group's padded weight operand — [K, N] (shared) or
        [G_pad, K, N] (stacked) — from the persistent cache.

        Keyed by the ordered weight-key tuple + bucketed envelope and
        identity-guarded on the weight tensors themselves (see the module
        docstring for the rule). A hot-swap that CHANGES the key (a new
        params tree puts a new ``id(params)`` in every weight key) is caught
        by ``group`` — a params-free identity of the logical dispatch slot —
        whose key change drops the superseded entry at once. Both paths
        count in ``weight_invalidations``. On a hit, the bytes of the packed
        operand are counted as traffic NOT re-staged this tick.

        ``device`` (the mesh slot) is part of the key: the per-device op
        pools share one executor, and a pack modelled as resident on one
        device must not serve another's dispatch."""
        key = ("wpack", "shared" if shared else "stacked",
               tuple(wkeys), K, N, G_pad, str(weights[0].dtype), device)

        def build() -> torch.Tensor:
            # the kernel takes contiguous operands only; F.pad returns a
            # strided clone when nothing needs padding (a tied unembed's
            # ``.T`` view would stay transposed)
            parts = [_pad_rows_cols(w, K, N).contiguous() for w in weights]
            if shared:
                return parts[0]
            if G_pad > len(parts):
                parts.extend([torch.zeros_like(parts[0])]
                             * (G_pad - len(parts)))
            return torch.stack(parts, dim=0)

        return self._cached(key, build, tuple(weights), group)

    def _cached(self, key, build, guard: Tuple, group) -> torch.Tensor:
        """A packed operand from the persistent cache, with the hit, miss
        and invalidation counts."""
        inval0 = self.weight_cache.stats.invalidations
        value, hit = self.weight_cache.get_or_build_flagged(
            key, build, guard=guard, group=group)
        self.stats.weight_invalidations += \
            self.weight_cache.stats.invalidations - inval0
        if hit:
            self.stats.weight_hits += 1
            self.stats.bytes_not_copied += int(value.nbytes)
        else:
            self.stats.weight_misses += 1
        return value

    # ------------------------------------------------------------------
    def stacked_operand(self, wkey: Tuple, k: int, n: int, layers: int,
                        weight_fn, guard: Sequence[torch.Tensor], *,
                        group=None, device: int = 0) -> torch.Tensor:
        """One LAYER-STACKED weight operand, [layers, K, N] padded to the
        bucketed (K, N) envelope, from the persistent cache.

        The stacked-template counterpart of ``_packed_weights``: one entry
        per stacked operand per params generation, m-free, so one entry
        serves decode, prefill and every batch size. ``weight_fn`` builds
        the raw [layers, k, n] tensor (a [lo:hi) slice of the params tree's
        stacked blocks) and runs only on a miss. ``guard`` must be the
        ORIGINAL stacked params tensors, never per-build slices (a fresh
        slice every tick would read as a hot-swap and repack the whole
        stack). A real hot-swap puts a new ``id(params)`` in ``wkey``;
        ``group`` (params-free slot identity) drops the superseded entry,
        as in ``_packed_weights``, and keyed by the mesh slot ``device`` as
        it is."""
        K = envelope_bucket(int(k))
        N = envelope_bucket(int(n))
        key = ("wstack", wkey, int(layers), K, N,
               str(guard[0].dtype) if guard else "", device)

        def build() -> torch.Tensor:
            w = weight_fn()
            # the kernel takes contiguous operands only (see build() above)
            return F.pad(w, (0, N - int(w.shape[-1]),
                             0, K - int(w.shape[-2]))).contiguous()

        return self._cached(key, build, tuple(guard), group)

    # ------------------------------------------------------------------
    def execute(self, ops: Sequence[KernelOp], *,
                shared_operand: bool = False,
                device: int = 0) -> List[torch.Tensor]:
        """Execute a planned group on mesh slot ``device``; returns
        per-problem outputs in op order.

        Each op carries its operand binding (``op.payload`` =
        (activation, weight, weight_key), attached by
        ``JitSession._push_op``)."""
        # pack in CANONICAL op order so the same set of ops in another
        # order hits the same packed-weight entry; outputs are restored to
        # call order below
        order = sorted(range(len(ops)),
                       key=lambda i: (ops[i].stream_id, ops[i].tag,
                                      ops[i].seq_index))
        problems = [ops[i].payload[:2] for i in order]
        wkeys = [ops[i].payload[2] for i in order]
        if shared_operand:
            # equal weight keys must mean the identical tensor: the shared
            # regime loads ops[0]'s weight once for the whole group
            w0 = problems[0][1]
            bad = next((i for i, (_, w) in enumerate(problems)
                        if w is not w0), None)
            if bad is not None:
                raise OperandIdentityHazard(
                    "shared-operand dispatch over non-identical weight "
                    f"tensors: key {wkeys[0]} vs {wkeys[bad]}",
                    detail={"keys": (wkeys[0], wkeys[bad])})
        group = (tuple((ops[i].stream_id, ops[i].tag, ops[i].seq_index)
                       for i in order), shared_operand, device)
        canon = self.execute_problems(problems, wkeys,
                                      shared_operand=shared_operand,
                                      group=group, device=device)
        outs: List[Optional[torch.Tensor]] = [None] * len(ops)
        for pos, i in enumerate(order):
            outs[i] = canon[pos]
        return outs

    def execute_problems(self, problems, wkeys, *,
                         shared_operand: bool = False, group=None,
                         device: int = 0) -> List[torch.Tensor]:
        bm = self.bm
        acts = tuple(a for a, _ in problems)
        ws = [w for _, w in problems]
        G = len(acts)
        self.stats.dispatches += 1
        builds0 = build_count()
        # bucket the problem COUNT too; pad entries are zero activations
        # (cheapest member's shape) whose outputs are dropped
        G_pad = _pow2(G)
        if G_pad > G:
            pad = torch.zeros_like(min(acts, key=lambda a: int(a.shape[0])))
            acts = acts + (pad,) * (G_pad - G)
        on = acts[0].device
        if shared_operand:
            w = ws[0]
            K = envelope_bucket(int(w.shape[0]))
            N = envelope_bucket(int(w.shape[1]))
            m_tiles = _tile_bucket([sum(int(a.shape[0]) for a in acts)], bm)
            b = self._packed_weights([w], [wkeys[0]], K, N, 1, shared=True,
                                     group=group, device=device)
            outs = _dispatch_shared(acts, b,
                                    self.group_ids((0,) * m_tiles, on),
                                    n_real=int(w.shape[1]), m_tiles=m_tiles,
                                    bm=bm)
        else:
            K = envelope_bucket(max(int(w.shape[0]) for w in ws))
            N = envelope_bucket(max(int(w.shape[1]) for w in ws))
            m_tiles = _tile_bucket([int(a.shape[0]) for a in acts], bm)
            b = self._packed_weights(ws, wkeys, K, N, G_pad, shared=False,
                                     group=group, device=device)
            n_real = [int(w.shape[1]) for w in ws]
            n_real += [n_real[0]] * (G_pad - G)
            gids = []
            for g, a in enumerate(acts):
                # pad problems read group 0's weights: their activations
                # are zero, so the product is zero and never read back
                gids.extend([g if g < G else 0]
                            * (_round_up(int(a.shape[0]), bm) // bm))
            gids.extend([0] * (m_tiles - len(gids)))  # pad tiles: group 0
            outs = _dispatch_grouped(
                acts, b, self.group_ids(tuple(gids), on),
                n_real=tuple(n_real), m_tiles=m_tiles, bm=bm)
        self.stats.retraces += build_count() - builds0
        return list(outs[:G])

    # ------------------------------------------------------------------
    def matvec(self, xs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor],
               *, group=None) -> List[torch.Tensor]:
        """G matvecs (x [k], w [k, n]) with the packed weight operand cached
        persistently (keyed on the weight tensors' identity). Dispatches the
        shared-weight GEMM regime when every problem uses the same weight
        tensor, exactly like the eager ``kernels.ops.coalesced_matvec``.

        A caller that hot-swaps its weights should pass a stable ``group``
        (any hashable identity of ITS dispatch slot): the ``id(w)``-based
        keys change with every swap, and without a group tag the
        superseded packed stacks — each pinning its dead weight tensors via
        the guard — are only reclaimed by the cache's LRU/byte bounds."""
        if all(w is ws[0] for w in ws):
            outs = self.execute_problems(
                [(x[None, :], ws[0]) for x in xs],
                [matvec_weight_key(ws[0], shared=True)] * len(xs),
                shared_operand=True, group=group)
            return [o[0] for o in outs]
        self.stats.dispatches += 1
        builds0 = build_count()
        G = len(xs)
        G_pad = _pow2(G)
        K = envelope_bucket(max(int(w.shape[0]) for w in ws))
        N = envelope_bucket(max(int(w.shape[1]) for w in ws))
        wkeys = [matvec_weight_key(w) for w in ws]
        w_stacked = self._packed_weights(ws, wkeys, K, N, G_pad,
                                         shared=False, group=group)
        xs = tuple(xs)
        n_real = [int(w.shape[1]) for w in ws]
        if G_pad > G:
            xs = xs + (torch.zeros_like(xs[0]),) * (G_pad - G)
            n_real += [n_real[0]] * (G_pad - G)
        outs = _dispatch_matvec(xs, w_stacked, n_real=tuple(n_real))
        self.stats.retraces += build_count() - builds0
        return list(outs[:G])
