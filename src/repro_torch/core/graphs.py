"""CUDA graphs of the stacked decode bodies — the port's compiled layer scans.

The JAX package compiles each layer body of a stacked template once per
executor tile: ``jax.jit(make_scan(bm, bn, bk, ...))`` memoized in the
body's ``jits`` dict (dense and MoE ``_stacked_dense_body_stage``, SSM
``_build_stacked_ssm_decode_template``). The port's body is a Python loop
that issues every op from the host, so a 48-layer decode step costs tens
of ms of host time for a few ms of device work. ``GraphCache`` holds the
counterpart of that ``jits`` dict: one ``torch.cuda.CUDAGraph`` per body
key, captured at the body's first call and replayed after it.

A body takes the ``BodyIO`` form: ``read(env)`` gives its inputs (the
residual stream ``x`` and its cache slices, and for attention the row
positions ``pos``), ``body(inputs, padded, ex, block)`` returns its outputs
(``x`` and the body's new cache chunk), and ``write_outputs`` hands them to
the program's env. The eager path runs the same three functions.

**Key**, as the JAX package keys its jits (the tile), plus what a graph
holds by raw pointer or by shape: ``BodyIO.key`` (phase, model config,
batch), the body's weight key, the launch ``bm`` (the tuned ``block.bm`` or
the executor's), the identities of the padded operands the body reads, and
the inputs' shapes and dtypes. Two tenants on one weight set share a key.

**Capture.** The first call of a key runs the body eagerly on the capture
stream (its outputs are this call's result), so nothing happens for the
first time under capture: the kernel build and load, the group ids' host
copy, the rope tables, cuBLAS's handle and workspace on that stream. Then
one call is captured on static copies of the inputs. A capture or replay
that fails raises: there is no eager fallback.

**Replay** copies the inputs into the static buffers, replays, and copies
the outputs out. The copy-out is the aliasing rule: a static output is
overwritten by the next replay of its key, which may be another tenant's,
and a single body's chunk becomes the tenant's cache as it is
(``jit._join_chunks``), so no env may hold one. It costs the bytes of the
outputs (and the copy-in those of the inputs) once a replay; the
alternative, one graph per stream, would hold a pool and static buffers a
tenant. All graphs of a cache share one memory pool: a replay only ever
reads its own static inputs (allocated outside the pool) and its outputs
are copied out before any other replay, so a graph's intermediates may
overlap another's.

**Weights.** A graph reads the executor's padded packs by raw pointer and
holds them only weakly. The weight cache can evict a pack (its LRU byte
budget) or invalidate it (a hot-swap); ``drop_operand``, called by the
cache for every entry it drops, drops the graphs that read it, so a graph
neither keeps an evicted pack alive nor replays a freed one; a hit checks
besides that every operand is the live tensor it captured. A body whose
packs the cache does not hold all at once (a pack larger than the whole
budget, or a budget smaller than one body's packs, where fetching one
evicts another) runs eagerly: its packs are built anew each dispatch, so
no graph of it could be replayed.

**Counters.** A replay launches no wrapper, so the kernels' counters
(``launches``, ``max_groups``, ``launches_by_shape``, ``launches_by_bm``)
would miss its launches. The capture records the counters' change over the
captured call (and takes it back: nothing ran), and every replay adds it.
``DispatchStats.graph_captures`` / ``graph_replays`` count captures and
replays.

The CPU path never captures: a body whose inputs lie on the CPU runs
eagerly. A stand-in ``capture`` lets the CPU tests drive the cache.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels.coalesced_gemm import coalesced_gemm
from repro_torch.kernels.coalesced_gemv import coalesced_gemv
from repro_torch.kernels.flash_attention import flash_attention

Tensors = Dict[str, torch.Tensor]

# the kernel wrappers whose counters a replay adds to
_KERNELS = (coalesced_gemm, coalesced_gemv, flash_attention)


def write_outputs(env: Dict[str, Any], outs: Tensors) -> None:
    """A body's outputs into the program's env: ``x`` is the residual
    stream, every other output a cache chunk appended to ``new_layers``
    under its name (k / v, or an SSM's conv / h)."""
    for name, t in outs.items():
        if name == "x":
            env["x"] = t
        else:
            env["new_layers"][name].append(t)


@dataclasses.dataclass
class BodyIO:
    """A layer body as a function of tensors, the form a CUDA graph holds.
    ``key`` is what the body computes beyond its weights (phase, model
    config, batch); None for a body that is never captured (prefill)."""

    key: Optional[Tuple]
    read: Callable[[Dict[str, Any]], Tensors]
    body: Callable[..., Tensors]     # (inputs, padded, ex, block) -> outs

    def run(self, env: Dict[str, Any], padded: Tensors, ex,
            block=None) -> None:
        """The eager body: read, compute, write."""
        write_outputs(env, self.body(self.read(env), padded, ex, block))


# ---------------------------------------------------------------------------
# kernel counters
# ---------------------------------------------------------------------------

def _counters() -> Dict[Tuple[Any, str], Any]:
    """A copy of every kernel wrapper's counters (ints and dicts)."""
    out = {}
    for fn in _KERNELS:
        for name, v in vars(fn).items():
            if isinstance(v, dict):
                out[fn, name] = dict(v)
            elif isinstance(v, int):
                out[fn, name] = v
    return out


def _delta(before, after) -> Dict[Tuple[Any, str], Any]:
    """The counters' change over one call: counts subtract (dict counts by
    key); a ``max_*`` counter keeps the call's own maximum."""
    out = {}
    for k, v in after.items():
        if k[1].startswith("max_"):
            out[k] = v
        elif isinstance(v, dict):
            old = before.get(k, {})
            d = {kk: n - old.get(kk, 0) for kk, n in v.items()
                 if n != old.get(kk, 0)}
            if d:
                out[k] = d
        elif v != before.get(k, 0):
            out[k] = v - before.get(k, 0)
    return out


def _restore(snapshot) -> None:
    """Put the counters back as ``snapshot`` had them (dicts in place)."""
    for (fn, name), v in snapshot.items():
        if isinstance(v, dict):
            d = getattr(fn, name)
            d.clear()
            d.update(v)
        else:
            setattr(fn, name, v)


def _add(delta) -> None:
    """Add one replay's launches to the counters."""
    for (fn, name), v in delta.items():
        if name.startswith("max_"):
            setattr(fn, name, max(getattr(fn, name), v))
        elif isinstance(v, dict):
            d = getattr(fn, name)
            for kk, n in v.items():
                d[kk] = d.get(kk, 0) + n
        else:
            setattr(fn, name, getattr(fn, name) + v)


# ---------------------------------------------------------------------------
# capture
# ---------------------------------------------------------------------------

class CudaCapture:
    """One body captured into a ``torch.cuda.CUDAGraph`` on ``stream``,
    its allocations in ``pool``. ``static_out`` holds the outputs the
    replays write."""

    def __init__(self, fn: Callable[[Tensors], Tensors], static_in: Tensors,
                 stream, pool):
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: a thread that is not capturing (a serving daemon's
        # feeder) may still use the runtime meanwhile
        with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            self.static_out = fn(static_in)

    def replay(self) -> None:
        self.graph.replay()


@dataclasses.dataclass
class _Entry:
    graph: Any                     # CudaCapture or a stand-in
    static_in: Tensors
    operands: Tuple                # weakrefs to the padded packs read
    launches: Dict                 # kernel-counter change of one call

    def live(self, padded: Tensors) -> bool:
        return all(ref() is padded[tag] for tag, ref in self.operands)


class GraphCache:
    """The graphs of a ``VLIWJit``'s stacked decode bodies, by body key
    (see the module docstring). ``capture(fn, static_in, stream, pool)``
    builds one graph; the default is ``CudaCapture``, and a stand-in (any
    object with ``replay()`` and ``static_out``) drives the cache on the
    CPU. ``resident(pack)`` says whether the weight cache holds a pack."""

    def __init__(self, capture: Optional[Callable] = None,
                 resident: Callable[[torch.Tensor], bool] = lambda t: True):
        self._capture = capture or CudaCapture
        # whether the weight cache holds a pack (``PlanCache.holds``)
        self._resident = resident
        self._real = capture is None
        self._entries: Dict[Tuple, _Entry] = {}
        self._streams: Dict[int, Any] = {}
        self._pools: Dict[int, Any] = {}
        self.dropped = 0           # graphs dropped with a pack they read

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def key(st, inputs: Tensors, padded: Tensors, bm: int) -> Tuple:
        """A body's graph key: ``BodyIO.key`` (phase, config, batch), the
        body's weight key, the launch bm, the packs' identities and the
        inputs' shapes and dtypes."""
        return (st.graph.key, st.weight_key, int(bm),
                tuple((tag, id(t)) for tag, t in sorted(padded.items())),
                tuple((name, tuple(t.shape), str(t.dtype), str(t.device))
                      for name, t in sorted(inputs.items())))

    # ------------------------------------------------------------------
    def drop_operand(self, value: Any) -> None:
        """Drop every graph that reads ``value`` (the weight cache calls
        this for each entry it evicts or invalidates)."""
        for key in [k for k, e in self._entries.items()
                    if any(ref() is value for _, ref in e.operands)]:
            del self._entries[key]
            self.dropped += 1

    # ------------------------------------------------------------------
    def run(self, st, env: Dict[str, Any], padded: Tensors, ex,
            block=None) -> None:
        """Run layer body ``st`` on ``env``: a replay of its graph, or at
        its key's first call the eager body and a capture."""
        io = st.graph
        inputs = io.read(env)
        if (self._real and inputs["x"].device.type != "cuda") or not all(
                self._resident(t) for t in padded.values()):
            write_outputs(env, io.body(inputs, padded, ex, block))
            return
        bm = ex.bm if block is None else block.bm
        key = self.key(st, inputs, padded, bm)
        ent = self._entries.get(key)
        if ent is not None and not ent.live(padded):
            del self._entries[key]
            ent = None
        if ent is None:
            outs = self._capture_body(key, io, inputs, padded, ex, block)
            ex.stats.graph_captures += 1
        else:
            for name, t in ent.static_in.items():
                t.copy_(inputs[name])
            ent.graph.replay()
            outs = {name: t.clone()
                    for name, t in ent.graph.static_out.items()}
            _add(ent.launches)
            ex.stats.graph_replays += 1
        write_outputs(env, outs)

    def _capture_body(self, key, io: BodyIO, inputs: Tensors,
                      padded: Tensors, ex, block) -> Tensors:
        """The key's first call: the eager body on the capture stream (this
        call's result), then one capture on static copies of the inputs."""

        def fn(inp: Tensors) -> Tensors:
            return io.body(inp, padded, ex, block)

        dev = inputs["x"].device
        stream = pool = None
        if self._real:
            idx = dev.index if dev.index is not None \
                else torch.cuda.current_device()
            stream = self._streams.get(idx)
            if stream is None:
                stream = self._streams[idx] = torch.cuda.Stream(device=dev)
                self._pools[idx] = torch.cuda.graph_pool_handle()
            pool = self._pools[idx]
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                outs = fn(inputs)
            torch.cuda.current_stream(dev).wait_stream(stream)
        else:
            outs = fn(inputs)
        # the static inputs live outside the graphs' pool, on the stream
        # the replays copy into them from
        static_in = {n: t.clone() for n, t in inputs.items()}
        before = _counters()
        for (fn_, name) in before:
            if name.startswith("max_"):       # the call's own maximum
                setattr(fn_, name, 0)
        graph = self._capture(fn, static_in, stream, pool)
        launches = _delta(before, _counters())
        _restore(before)
        self._entries[key] = _Entry(
            graph, static_in,
            tuple((tag, weakref.ref(t)) for tag, t in sorted(padded.items())),
            launches)
        return outs


__all__ = ["BodyIO", "CudaCapture", "GraphCache", "write_outputs"]
