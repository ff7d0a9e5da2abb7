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

The JAX package ``jax.jit``s the three dispatch bodies, each keyed on its
static arguments and its operands' shapes. Their counterparts here are
CUDA graphs (core/graphs.py, kind ``"dispatch"``): a dispatch whose packed
weights the cache holds replays its key's graph — the activations copied
into views of one zeroed static packed buffer, the kernel's launch, one
clone of its output cut per problem — and captures it at the key's first
call. The key is the body and its static arguments (``n_real``,
``m_tiles``, ``bm``), the activations' shapes, strides and dtypes, and the
identities of the pack and the group-id vector, which the graph reads by
pointer. ``cuda_graphs=False`` (and every CPU tensor) runs the bodies
eagerly.

``DispatchStats.retraces`` counted jitted-body traces in the JAX package.
It keeps counting what a first call pays beside a capture: kernel library
builds during the dispatch (``kernels.build.build_count``, over all
kernels): one per library on its first CUDA dispatch in a process, 0 after
it and 0 on the CPU. The JAX package's steady-state "not one retrace" is,
here, "not one dispatch capture" (``dispatch_graph_captures``) in a second
run over warm templates.

Correctness contract: bucket padding is zeros, and adding ``+0.0`` terms to
an fp32 accumulator is exact, so the bucketed fast path computes the same
sums as the eager exact-envelope path up to the kernel's summation order.

Memory note: cached packed weights are full padded copies, bounded in
BYTES by ``VLIWJit(weight_budget_bytes=...)`` (default 1 GiB).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.clustering import matvec_weight_key
from repro_torch.core.costmodel import BlockConfig
from repro_torch.core.graphs import (DispatchIO, GraphCache, Tensors,
                                     copy_each)
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
    # CUDA graphs (core/graphs.py): captures (one a key) and replays of
    # the stacked bodies, decode and prefill
    graph_captures: int = 0
    graph_replays: int = 0
    # ... and by kind: the prefill bodies among them, the per-layer glue
    # stages, the monolithic Model.decode_step / Model.prefill calls
    prefill_graph_captures: int = 0
    prefill_graph_replays: int = 0
    glue_graph_captures: int = 0
    glue_graph_replays: int = 0
    monolithic_graph_captures: int = 0
    monolithic_graph_replays: int = 0
    # ... and the dispatch bodies (_dispatch_grouped / _shared / _matvec)
    dispatch_graph_captures: int = 0
    dispatch_graph_replays: int = 0

    @property
    def weight_hit_rate(self) -> float:
        n = self.weight_hits + self.weight_misses
        return self.weight_hits / n if n else 0.0

    def graphs_by_kind(self) -> Dict[str, Tuple[int, int]]:
        """{kind: (captures, replays)} for the five kinds of graph."""
        return {
            "decode": (self.graph_captures - self.prefill_graph_captures,
                       self.graph_replays - self.prefill_graph_replays),
            "prefill": (self.prefill_graph_captures,
                        self.prefill_graph_replays),
            "glue": (self.glue_graph_captures, self.glue_graph_replays),
            "monolithic": (self.monolithic_graph_captures,
                           self.monolithic_graph_replays),
            "dispatch": (self.dispatch_graph_captures,
                         self.dispatch_graph_replays)}

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


def _pad_members(acts: Tuple[torch.Tensor, ...],
                 G_pad: int) -> Tuple[torch.Tensor, ...]:
    """``acts`` extended to the bucketed problem count with zero
    activations of the cheapest member's shape (their outputs are
    dropped)."""
    if G_pad == len(acts):
        return acts
    pad = torch.zeros_like(min(acts, key=lambda a: int(a.shape[0])))
    return acts + (pad,) * (G_pad - len(acts))


def _packed_io(M: int, K: int, offsets: Sequence[int],
               n_real: Sequence[int],
               launch: Callable[[torch.Tensor, Tensors], torch.Tensor]
               ) -> DispatchIO:
    """A dispatch body in its graph's form (core/graphs.py ``DispatchIO``):
    input ``a{i}`` lands at row ``offsets[i]`` of one zeroed [M, K] packed
    buffer (a vector fills that row), the graph holds ``launch(packed,
    operands)`` alone, and the copy-out is one clone of the kernel's output
    cut as the eager body cuts it: ``o{i}`` is ``n_real[i]`` columns of
    input i's rows. The pad rows and columns are never written, so they
    stay zero."""
    cuts: List[Tuple[int, Optional[int]]] = []

    def stage(inputs: Tensors):
        a0 = inputs["a0"]
        packed = torch.zeros(M, K, dtype=a0.dtype, device=a0.device)
        targets = {}
        for i, off in enumerate(offsets):
            a = inputs[f"a{i}"]
            if a.dim() == 1:
                view, rows = packed[off, :a.shape[0]], None
            else:
                view = packed[off:off + a.shape[0], :a.shape[1]]
                rows = int(a.shape[0])
            targets[f"a{i}"] = view
            cuts.append((off, rows))
        copy_in = functools.partial(copy_each, targets)
        copy_in(inputs)
        return {"packed": packed}, copy_in

    def unpack(static_out: Tensors) -> Tensors:
        out = static_out["out"].clone()
        return {f"o{i}": out[off, :n] if rows is None
                else out[off:off + rows, :n]
                for i, ((off, rows), n) in enumerate(zip(cuts, n_real))}

    return DispatchIO(
        stage, lambda st, ops: {"out": launch(st["packed"], ops)}, unpack)


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
                 bm: int = 8, graphs: Optional[GraphCache] = None,
                 cuda_graphs: bool = True):
        assert bm & (bm - 1) == 0, f"bm must be a power of two, got {bm}"
        # packed-weight entries are full padded copies, so the fallback
        # cache is byte-budgeted too
        self.weight_cache = weight_cache if weight_cache is not None \
            else PlanCache(256, byte_capacity=1 << 30)
        # the packer's m-tile; the CUDA kernel tiles N and K itself
        self.bm = bm
        self.stats = DispatchStats()
        # the dispatch bodies' CUDA graphs (the module docstring). A
        # VLIWJit hands in its own cache: one memory pool, one drop path.
        # A standalone executor builds one that the weight cache's drops
        # reach, so an evicted or invalidated pack takes its graphs along.
        self.cuda_graphs = cuda_graphs
        if graphs is None:
            graphs = GraphCache(resident=self.weight_cache.holds)
            self.weight_cache.on_drop.append(graphs.drop_operand)
        self.graphs = graphs
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
                        device: int = 0) -> Tuple[torch.Tensor, bool]:
        """The group's padded weight operand — [K, N] (shared) or
        [G_pad, K, N] (stacked) — from the persistent cache, and whether the
        cache holds it (a pack larger than the whole byte budget passes
        through uncached, and no graph may read it by pointer).

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

        pack = self._cached(key, build, tuple(weights), group)
        return pack, key in self.weight_cache

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
                device: int = 0,
                block: Optional[BlockConfig] = None) -> List[torch.Tensor]:
        """Execute a planned group on mesh slot ``device``; returns
        per-problem outputs in op order.

        Each op carries its operand binding (``op.payload`` =
        (activation, weight, weight_key), attached by
        ``JitSession._push_op``). ``block`` is the group's live-tuned tile
        (``VLIWJit(live_tune=True)``; None keeps the executor's ``bm``).
        Its ``bm`` drives this dispatch: the m-tile bucket, the per-problem
        row padding, the group ids and the ``coalesced_gemm`` launch. A
        real row's result does not depend on it (the kernel's summation
        order is a function of K alone), so tuned and untuned runs give the
        same tokens. Its ``bn`` and ``bk`` stay modelled (the cost model's
        estimate and the trace): the kernel keeps its 128-column block and
        its K-only split, and a ``bk`` that reached it would change a row's
        summation order. The packed weights depend on (K, N) alone, so a
        change of tuned block repacks nothing."""
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
                                      group=group, device=device,
                                      block=block)
        outs: List[Optional[torch.Tensor]] = [None] * len(ops)
        for pos, i in enumerate(order):
            outs[i] = canon[pos]
        return outs

    def execute_problems(self, problems, wkeys, *,
                         shared_operand: bool = False, group=None,
                         device: int = 0,
                         block: Optional[BlockConfig] = None
                         ) -> List[torch.Tensor]:
        # the live-tuned m-tile (see ``execute``); the tuner's candidates
        # are powers of two, which the m-tile bucketing relies on
        bm = self.bm if block is None else block.bm
        assert bm & (bm - 1) == 0, f"bm must be a power of two, got {bm}"
        acts = tuple(a for a, _ in problems)
        ws = [w for _, w in problems]
        G = len(acts)
        self.stats.dispatches += 1
        builds0 = build_count()
        # bucket the problem COUNT too; pad entries are zero activations
        # (cheapest member's shape) whose outputs are dropped
        G_pad = _pow2(G)
        rows = [int(a.shape[0]) for a in acts]
        rows += [min(rows)] * (G_pad - G)
        on = acts[0].device
        if shared_operand:
            w = ws[0]
            K = envelope_bucket(int(w.shape[0]))
            N = envelope_bucket(int(w.shape[1]))
            n = int(w.shape[1])
            m_tiles = _tile_bucket([sum(rows)], bm)
            b, held = self._packed_weights([w], [wkeys[0]], K, N, 1,
                                           shared=True, group=group,
                                           device=device)
            gids = self.group_ids((0,) * m_tiles, on)
            head = ("shared", n, m_tiles, bm)
            body = functools.partial(_dispatch_shared, n_real=n,
                                     m_tiles=m_tiles, bm=bm)
            n_real = (n,) * G
            offsets, s = [], 0
            for m in rows[:G]:          # concatenated tightly
                offsets.append(s)
                s += m
        else:
            K = envelope_bucket(max(int(w.shape[0]) for w in ws))
            N = envelope_bucket(max(int(w.shape[1]) for w in ws))
            m_tiles = _tile_bucket(rows, bm)
            b, held = self._packed_weights(ws, wkeys, K, N, G_pad,
                                           shared=False, group=group,
                                           device=device)
            n_real = [int(w.shape[1]) for w in ws]
            n_real = tuple(n_real + [n_real[0]] * (G_pad - G))
            ids, offsets = [], []
            for g, m in enumerate(rows):
                # pad problems read group 0's weights: their activations
                # are zero, so the product is zero and never read back
                offsets.append(len(ids) * bm)
                ids.extend([g if g < G else 0] * (_round_up(m, bm) // bm))
            ids.extend([0] * (m_tiles - len(ids)))  # pad tiles: group 0
            gids = self.group_ids(tuple(ids), on)
            head = ("grouped", n_real, m_tiles, bm)
            body = functools.partial(_dispatch_grouped, n_real=n_real,
                                     m_tiles=m_tiles, bm=bm)
        if self.cuda_graphs and held:
            def launch(a: torch.Tensor, ops: Tensors) -> torch.Tensor:
                w_ = ops["b"][None] if shared_operand else ops["b"]
                return coalesced_gemm(a, w_, ops["gids"], bm=bm)

            outs = self._graphed(
                head, lambda xs, ops: body(xs, ops["b"], ops["gids"]),
                acts, G_pad, {"b": b, "gids": gids},
                lambda: _packed_io(m_tiles * bm, K, offsets[:G],
                                   n_real[:G], launch))
        else:
            outs = body(_pad_members(acts, G_pad), b, gids)[:G]
        self.stats.retraces += build_count() - builds0
        return list(outs)

    def _graphed(self, head: Tuple, body, acts: Tuple[torch.Tensor, ...],
                 G_pad: int, operands: Tensors,
                 io: Callable[[], DispatchIO]) -> List[torch.Tensor]:
        """A dispatch body ``body(padded activations, operands) -> outputs``
        through its CUDA graph (``GraphCache.call``, kind ``"dispatch"``):
        the real activations are the graph's inputs, the pad members stay
        zero rows of its packed buffer. ``io()`` builds the graph's form at
        the key's first call."""
        G = len(acts)

        def eager(inp: Tensors, ops: Tensors) -> Tensors:
            xs = _pad_members(tuple(inp[f"a{i}"] for i in range(G)), G_pad)
            return {f"o{i}": o for i, o in enumerate(body(xs, ops)[:G])}

        outs = self.graphs.call(
            "dispatch", head, eager, {f"a{i}": a for i, a in enumerate(acts)},
            operands, self.stats, io=io)
        return [outs[f"o{i}"] for i in range(G)]

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
        w_stacked, held = self._packed_weights(ws, wkeys, K, N, G_pad,
                                               shared=False, group=group)
        xs = tuple(xs)
        n_real = [int(w.shape[1]) for w in ws]
        n_real = tuple(n_real + [n_real[0]] * (G_pad - G))
        body = functools.partial(_dispatch_matvec, n_real=n_real)
        if self.cuda_graphs and held:
            outs = self._graphed(
                ("matvec", n_real), lambda v, ops: body(v, ops["w"]), xs,
                G_pad, {"w": w_stacked},
                lambda: _packed_io(G_pad, K, range(G), n_real[:G],
                                   lambda x, ops: coalesced_gemv(x,
                                                                 ops["w"])))
        else:
            outs = body(_pad_members(xs, G_pad), w_stacked)[:G]
        self.stats.retraces += build_count() - builds0
        return list(outs)
