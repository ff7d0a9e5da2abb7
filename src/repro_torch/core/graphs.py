"""CUDA graphs of the port's compiled serving path.

The JAX package compiles four kinds of thing on its serving path:

  * each layer body of a stacked template, once per executor tile:
    ``jax.jit(make_scan(bm, bn, bk, ...))`` memoized in the body's ``jits``
    dict (dense and MoE ``_stacked_dense_body_stage``, SSM
    ``_build_stacked_ssm_decode_template``, the prompt pass's
    ``_stacked_prefill_body_stage``);
  * the per-layer regime's glue, ``_GLUE_JITS``: ``decode-attend``,
    ``prefill-attend``, ``moe-route``, ``moe-combine`` and ``ssm-core``,
    each a ``jax.jit`` keyed on its static arguments;
  * the layers of the monolithic ``Model.decode_step`` and
    ``Model.prefill`` under ``jax.lax.scan``, which the serving engine
    calls for its baseline modes and for the tenants the JIT does not
    compile (hybrid, audio, int8-KV decode; every prompt it does not
    declare);
  * the executor's dispatch bodies, ``_dispatch_grouped``,
    ``_dispatch_shared`` and ``_dispatch_matvec`` (core/dispatch.py), each
    a ``jax.jit`` keyed on its static arguments and operand shapes: every
    plain GEMM dispatch (a per-layer GEMM, a stacked program's unembed, a
    matvec tick) runs one.

The port's counterparts are Python loops that issue every op from the
host, so a 48-layer decode step costs tens of ms of host time for a few
ms of device work. ``GraphCache`` holds one ``torch.cuda.CUDAGraph`` per
key of any of the five kinds (``KINDS``: a decode body, a prefill body, a
glue stage, a monolithic call, a dispatch body), captured at the key's
first call and replayed after it, all through one path,
``GraphCache.call``.

**A call** is ``fn(inputs, operands) -> outputs``, each a dict of tensors.
``inputs`` are what the JAX package passes as the jit's arguments (a
body's residual stream, positions and cache slices; a glue stage's q / k /
v, cache slices, router weights or mamba parameters; a monolithic call's
tokens, cache leaves, patch embeddings or frames): a replay copies them
into static buffers of the same shapes and strides. ``operands`` are read
by raw pointer and held only weakly: a body's padded packs, a monolithic
call's params, a dispatch's packed weights and group ids. A body takes the
``BodyIO`` form, a glue stage the ``GlueIO`` form; ``monolithic`` flattens
a model call's trees. A dispatch body takes the ``DispatchIO`` form: its
inputs are the group's activations, copied into views of one zeroed
packed buffer (its pad rows and columns stay zero), and the graph holds
the kernel's launch on that buffer alone; the copy-out is one clone of the
kernel's output, cut per problem as the eager body cuts it.

**Key**, as the JAX package keys its jits: a body's ``BodyIO.key``
(phase, model config, batch or prompt bucket), its weight key and the
launch ``bm``; a glue stage's ``_GLUE_JITS`` key; a monolithic call's
method, config, param dtype, ``kv_quant`` (and a prefill's cache length);
a dispatch body's name and static arguments (``n_real``, ``m_tiles``,
``bm``). ``call`` adds what a graph holds by pointer or by shape: the
operands' identities and the inputs' shapes, strides and dtypes (a jit
retraces per shape, too). Two tenants on one weight set share every key.

**Capture.** The first call of a key runs ``fn`` eagerly on the capture
stream (its outputs are this call's result), so nothing happens for the
first time under capture: the kernel build and load, the group ids' host
copy, the rope tables, cuBLAS's handle and workspace on that stream. Then
one call is captured on static copies of the inputs with
``CUDAGraph.capture_begin`` / ``capture_end`` on the capture stream, which
first waits for the current one. ``torch.cuda.graph`` would also
synchronize the device and empty the allocator's cache on entry, a cost a
capture paid on every key; instead a one-op keeper graph holds the pool
live (``_stream_and_pool``). A capture or replay that fails raises: there
is no eager fallback. ``capture_s`` keeps the host seconds of each kind's
first calls (the eager call and the capture).

**Replay** copies the inputs into the static buffers, replays, and copies
the outputs out. The copy-out is the aliasing rule: a static output is
overwritten by the next replay of its key, which may be another tenant's,
and an output may become a tenant's cache as it is, so no caller may hold
one. All graphs of a cache share one memory pool: a replay only ever
reads its own static inputs (allocated outside the pool) and its outputs
are copied out before any other replay, so a graph's intermediates may
overlap another's.

**Operands.** A graph holds its operands by weak reference. The weight
cache can evict a pack (its LRU byte budget) or invalidate it (a
hot-swap); ``drop_operand``, called by the cache for every entry it drops,
drops the graphs that read it, so a graph neither keeps an evicted pack
alive nor replays a freed one. An operand that dies otherwise (a
monolithic call's params after a hot-swap, ``tenant.params = new``)
drops its graphs through the weak reference's callback. A hit checks
besides that every operand is the live tensor it captured. A body whose
packs the cache does not hold all at once (a pack larger than the whole
budget, or a budget smaller than one body's packs, where fetching one
evicts another) runs eagerly: its packs are built anew each dispatch, so
no graph of it could be replayed.

**Counters.** A replay launches no wrapper, so the kernels' counters
(``launches``, ``max_groups``, ``launches_by_shape``, ``launches_by_bm``)
would miss its launches. The capture records the counters' change over the
captured call (and takes it back: nothing ran), and every replay adds it.
``DispatchStats`` counts captures and replays: ``graph_captures`` /
``graph_replays`` the bodies (decode and prefill), and a pair a kind
beside them (``graphs_by_kind``). A graph reads its operands by pointer,
so the key holds their identities: the per-layer regime captures one
dispatch graph a (signature, pack), where the JAX package compiles one a
signature.

The CPU path never captures: a call whose inputs lie on the CPU runs
eagerly. A stand-in ``capture`` lets the CPU tests drive the cache.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.kernels.coalesced_gemm import coalesced_gemm
from repro_torch.kernels.coalesced_gemv import coalesced_gemv
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.tree import flatten_with_path, path_key

Tensors = Dict[str, torch.Tensor]

# the kernel wrappers whose counters a replay adds to
_KERNELS = (coalesced_gemm, coalesced_gemv, flash_attention)

# a decode body, a prefill body, a per-layer glue stage, a monolithic call,
# an executor dispatch body
KINDS = ("decode", "prefill", "glue", "monolithic", "dispatch")


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
    ``key`` is what the body computes beyond its weights: (phase, model
    config, batch) for a decode body, (phase, model config, prompt bucket)
    for a prefill body; its first element is the body's kind."""

    key: Tuple
    read: Callable[[Dict[str, Any]], Tensors]
    body: Callable[..., Tensors]     # (inputs, padded, ex, block) -> outs

    def run(self, env: Dict[str, Any], padded: Tensors, ex,
            block=None) -> None:
        """The eager body: read, compute, write."""
        write_outputs(env, self.body(self.read(env), padded, ex, block))


@dataclasses.dataclass
class GlueIO:
    """A per-layer glue stage as a function of tensors. ``bind(env)``
    gives (key, fn, inputs): the JAX package's ``_GLUE_JITS`` key of this
    call, ``fn(inputs) -> outputs`` (the same function for one key) and the
    inputs read from the env; ``write(env, outputs)`` lands the outputs."""

    bind: Callable[[Dict[str, Any]],
                   Tuple[Tuple, Callable[[Tensors], Tensors], Tensors]]
    write: Callable[[Dict[str, Any], Tensors], None]

    def run(self, env: Dict[str, Any]) -> None:
        """The eager stage."""
        _, fn, inputs = self.bind(env)
        self.write(env, fn(inputs))


@dataclasses.dataclass
class DispatchIO:
    """An executor dispatch body in the form its graph holds.
    ``stage(inputs)`` makes the static buffers the launch reads (a zeroed
    packed buffer), writes the inputs into them and returns (static,
    copy_in): ``copy_in(inputs)`` writes a later call's inputs into the same
    places before its replay. ``launch(static, operands)`` is the captured
    call; ``unpack(static_out)`` the copy-out."""

    stage: Callable[[Tensors], Tuple[Tensors, Callable[[Tensors], None]]]
    launch: Callable[[Tensors, Tensors], Tensors]
    unpack: Callable[[Tensors], Tensors]


def _clones(static_out: Tensors) -> Tensors:
    """The copy-out of every kind but a dispatch: a clone an output."""
    return {name: t.clone() for name, t in static_out.items()}


def copy_each(targets: Tensors, inputs: Tensors) -> None:
    """The copy-in of every kind: each input into its static buffer
    (``targets[name]``; for a dispatch, a view of its packed buffer)."""
    for name, t in inputs.items():
        targets[name].copy_(t)


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


def _count(stats, kind: str, what: str) -> None:
    """One capture or replay (``what``) of ``kind`` into ``stats``: the
    bodies' pair, and the kind's own pair for all but decode bodies."""
    if stats is None:
        return
    if kind in ("decode", "prefill"):
        name = f"graph_{what}"
        setattr(stats, name, getattr(stats, name) + 1)
    if kind != "decode":
        name = f"{kind}_graph_{what}"
        setattr(stats, name, getattr(stats, name) + 1)


# ---------------------------------------------------------------------------
# trees and static buffers
# ---------------------------------------------------------------------------

def flatten(tree: Any) -> Tensors:
    """A tree of dicts of tensors as {``/``-joined path: tensor}."""
    return {path_key(p): t for p, t in flatten_with_path(tree)}


def unflatten(flat: Tensors) -> Dict[str, Any]:
    """``flatten``'s inverse."""
    out: Dict[str, Any] = {}
    for path, t in flat.items():
        *heads, last = path.split("/")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = t
    return out


def _signature(inputs: Tensors) -> Tuple:
    # in the caller's order (one caller builds one order): a dispatch
    # graph's key is built on every plain GEMM dispatch
    return tuple((n, t.shape, t.stride(), t.dtype, t.device)
                 for n, t in inputs.items())


def _identities(operands: Tensors) -> Tuple:
    return tuple((tag, id(t)) for tag, t in sorted(operands.items()))


def _static(t: torch.Tensor) -> torch.Tensor:
    """A static input buffer: a copy of ``t`` with its shape and strides,
    so the graph computes on the layout the eager call saw."""
    return torch.empty_strided(tuple(t.shape), t.stride(), dtype=t.dtype,
                               device=t.device).copy_(t)


def _body_head(st, bm: int) -> Tuple:
    """A body's key beyond its operands and inputs: ``BodyIO.key``, the
    body's weight key and the launch bm."""
    return (st.graph.key, st.weight_key, int(bm))


# ---------------------------------------------------------------------------
# capture
# ---------------------------------------------------------------------------

class CudaCapture:
    """One call captured into a ``torch.cuda.CUDAGraph`` on ``stream``, its
    allocations in ``pool``. ``static_out`` holds the outputs the replays
    write. ``capture_begin`` / ``capture_end`` directly, not
    ``torch.cuda.graph``: no device synchronize or allocator flush a
    capture (the module docstring)."""

    def __init__(self, fn: Callable[[Tensors], Tensors], static_in: Tensors,
                 stream, pool):
        self.graph = torch.cuda.CUDAGraph()
        # the static inputs were written on the current stream
        stream.wait_stream(torch.cuda.current_stream(stream.device))
        # the collector stays off while capturing: it may free a dead
        # cache's graphs (the weight cache and the graph cache hold each
        # other) at any allocation, and a graph destroyed mid-capture
        # invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(stream):
                # thread_local: a thread that is not capturing (a serving
                # daemon's feeder) may still use the runtime meanwhile
                self.graph.capture_begin(pool=pool,
                                         capture_error_mode="thread_local")
                try:
                    self.static_out = fn(static_in)
                except BaseException:
                    try:             # ends the invalidated capture; the
                        self.graph.capture_end()   # first error is the one
                    except RuntimeError:           # that is raised
                        pass
                    raise
                self.graph.capture_end()
        finally:
            if collecting:
                gc.enable()

    def replay(self) -> None:
        self.graph.replay()


@dataclasses.dataclass
class _Entry:
    kind: str
    head: Tuple                    # the caller's key
    graph: Any                     # CudaCapture or a stand-in
    copy_in: Callable[[Tensors], None]     # the inputs into the buffers
    operands: Tuple                # (tag, weakref) of the operands read
    launches: Dict                 # kernel-counter change of one call
    unpack: Callable[[Tensors], Tensors]   # the copy-out

    def live(self, operands: Tensors) -> bool:
        return all(ref() is operands[tag] for tag, ref in self.operands)

    def dead(self) -> bool:
        return any(ref() is None for _, ref in self.operands)


class GraphCache:
    """The CUDA graphs of a ``VLIWJit`` and its serving engine, by key (see
    the module docstring). ``capture(fn, static_in, stream, pool)`` builds
    one graph; the default is ``CudaCapture``, and a stand-in (any object
    with ``replay()`` and ``static_out``) drives the cache on the CPU.
    ``resident(pack)`` says whether the weight cache holds a pack."""

    def __init__(self, capture: Optional[Callable] = None,
                 resident: Callable[[torch.Tensor], bool] = lambda t: True):
        self._capture = capture or CudaCapture
        # whether the weight cache holds a pack (``PlanCache.holds``)
        self._resident = resident
        self._real = capture is None
        self._entries: Dict[Tuple, _Entry] = {}
        # keys whose operand died (weakref callbacks; purged at the next
        # call, never from inside a callback)
        self._dead: List[Tuple] = []
        self._streams: Dict[int, Any] = {}
        self._pools: Dict[int, Any] = {}
        self._keepers: Dict[int, CudaCapture] = {}
        self.dropped = 0           # graphs dropped with an operand they read
        # host seconds of each kind's first calls (eager call + capture)
        self.capture_s = {kind: 0.0 for kind in KINDS}

    def __len__(self) -> int:
        self._purge()
        return len(self._entries)

    def count(self, kind: str) -> int:
        """The graphs held of one kind."""
        self._purge()
        return sum(e.kind == kind for e in self._entries.values())

    def heads(self, kind: str) -> set:
        """The callers' keys of the graphs held of one kind (for glue, the
        JAX package's ``_GLUE_JITS`` keys)."""
        self._purge()
        return {e.head for e in self._entries.values() if e.kind == kind}

    @staticmethod
    def _full_key(kind: str, head: Tuple, inputs: Tensors,
                  operands: Tensors) -> Tuple:
        return (kind, head, _identities(operands), _signature(inputs))

    @staticmethod
    def key(st, inputs: Tensors, padded: Tensors, bm: int) -> Tuple:
        """A body's graph key: ``BodyIO.key`` (phase, config, batch or
        bucket), the body's weight key, the launch bm, the packs'
        identities and the inputs' shapes, strides and dtypes."""
        return GraphCache._full_key(st.graph.key[0], _body_head(st, bm),
                                    inputs, padded)

    # ------------------------------------------------------------------
    def drop_operand(self, value: Any) -> None:
        """Drop every graph that reads ``value`` (the weight cache calls
        this for each entry it evicts or invalidates)."""
        self._purge()
        for key in [k for k, e in self._entries.items()
                    if any(ref() is value for _, ref in e.operands)]:
            del self._entries[key]
            self.dropped += 1

    def _purge(self) -> None:
        while self._dead:
            key = self._dead.pop()
            ent = self._entries.get(key)
            if ent is not None and ent.dead():
                del self._entries[key]
                self.dropped += 1

    def _watch(self, key: Tuple, t: torch.Tensor) -> "weakref.ref":
        dead = self._dead          # the callback holds the list, not self
        return weakref.ref(t, lambda _ref: dead.append(key))

    # ------------------------------------------------------------------
    def run(self, st, env: Dict[str, Any], padded: Tensors, ex,
            block=None) -> None:
        """Run layer body ``st`` on ``env``: a replay of its graph, or at
        its key's first call the eager body and a capture."""
        io = st.graph
        inputs = io.read(env)
        if not all(self._resident(t) for t in padded.values()):
            write_outputs(env, io.body(inputs, padded, ex, block))
            return
        bm = ex.bm if block is None else block.bm

        def fn(inp: Tensors, ops: Tensors) -> Tensors:
            return io.body(inp, ops, ex, block)

        write_outputs(env, self.call(io.key[0], _body_head(st, bm), fn,
                                     inputs, padded, ex.stats))

    def glue(self, io: GlueIO, env: Dict[str, Any], stats=None) -> None:
        """Run per-layer glue stage ``io`` on ``env`` as a graph of its
        ``_GLUE_JITS`` key (its inputs copied in: one graph serves every
        layer of the key, as one jitted function does)."""
        key, fn, inputs = io.bind(env)
        io.write(env, self.call("glue", key, lambda inp, ops: fn(inp),
                                inputs, {}, stats))

    def monolithic(self, head: Tuple, fn: Callable[[Any, Any], Any],
                   params, args, stats=None) -> Dict[str, Any]:
        """``fn(params, args) -> dict`` (trees of tensors) as a graph keyed
        on ``head``: the params' leaves are its operands (read by pointer,
        held weakly), the args' leaves its inputs. ``fn`` must not hold the
        params itself."""

        def flat_fn(inp: Tensors, ops: Tensors) -> Tensors:
            return flatten(fn(unflatten(ops), unflatten(inp)))

        return unflatten(self.call("monolithic", head, flat_fn,
                                   flatten(args), flatten(params), stats))

    def call(self, kind: str, head: Tuple,
             fn: Callable[[Tensors, Tensors], Tensors], inputs: Tensors,
             operands: Optional[Tensors] = None, stats=None,
             io: Optional[Callable[[], DispatchIO]] = None) -> Tensors:
        """``fn(inputs, operands)``: a replay of the graph of ``head`` (see
        the module docstring), or at its first call the eager call and a
        capture; eager on the CPU. Counts into ``stats``
        (``DispatchStats``). ``io()`` (a dispatch body; called at the
        key's first call only) gives the static buffers, the captured call
        and the copy-out; without it the graph captures ``fn`` on a static
        copy of each input and clones each output."""
        assert kind in KINDS, kind
        operands = operands or {}
        self._purge()
        if self._real and next(iter(inputs.values())).device.type != "cuda":
            return fn(inputs, operands)
        key = self._full_key(kind, head, inputs, operands)
        ent = self._entries.get(key)
        if ent is not None and not ent.live(operands):
            del self._entries[key]
            ent = None
        if ent is None:
            t0 = time.perf_counter()
            outs = self._capture_call(key, kind, head, fn, inputs, operands,
                                      io)
            self.capture_s[kind] += time.perf_counter() - t0
            _count(stats, kind, "captures")
            return outs
        ent.copy_in(inputs)
        ent.graph.replay()
        outs = ent.unpack(ent.graph.static_out)
        _add(ent.launches)
        _count(stats, kind, "replays")
        return outs

    def _stream_and_pool(self, dev: torch.device):
        """The capture stream and memory pool of ``dev``, made at its first
        capture together with a keeper: a one-op graph captured into the
        pool and held as long as the cache. A pool whose graphs have all
        been destroyed (a weight cache emptied at once) becomes freeable,
        and the allocators refuse a capture into a freeable pool until
        their caches are emptied (``torch.cuda.graph`` empties them before
        every capture); the keeper keeps the pool live, so the memory of
        dropped graphs stays in it for the next captures."""
        idx = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        if idx not in self._streams:
            stream = torch.cuda.Stream(device=dev)
            pool = torch.cuda.graph_pool_handle()
            one = torch.zeros(1, device=dev)
            self._keepers[idx] = CudaCapture(
                lambda inp: {"one": inp["one"].add_(1.0)}, {"one": one},
                stream, pool)
            self._streams[idx], self._pools[idx] = stream, pool
        return self._streams[idx], self._pools[idx]

    def _capture_call(self, key, kind: str, head: Tuple, fn,
                      inputs: Tensors, operands: Tensors,
                      io: Optional[Callable[[], DispatchIO]]) -> Tensors:
        """The key's first call: the eager call on the capture stream (this
        call's result), then one capture on static copies of the inputs
        (``io``: of its staged buffers). The captured function reaches the
        operands through weak references only (a stand-in keeps it for its
        replays)."""
        refs = tuple((tag, self._watch(key, t))
                     for tag, t in sorted(operands.items()))
        if io is not None:
            io = io()
        captured = fn if io is None else io.launch

        def bound(inp: Tensors) -> Tensors:
            return captured(inp, {tag: ref() for tag, ref in refs})

        dev = next(iter(inputs.values())).device
        stream = pool = None
        if self._real:
            stream, pool = self._stream_and_pool(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                outs = fn(inputs, operands)
            torch.cuda.current_stream(dev).wait_stream(stream)
        else:
            outs = fn(inputs, operands)
        # the static inputs live outside the graphs' pool, on the stream
        # the replays copy into them from
        if io is None:
            static_in = {n: _static(t) for n, t in inputs.items()}
            copy_in = functools.partial(copy_each, static_in)
            unpack = _clones
        else:
            static_in, copy_in = io.stage(inputs)
            unpack = io.unpack
        before = _counters()
        for (fn_, name) in before:
            if name.startswith("max_"):       # the call's own maximum
                setattr(fn_, name, 0)
        try:
            graph = self._capture(bound, static_in, stream, pool)
        finally:
            launches = _delta(before, _counters())
            _restore(before)
        self._entries[key] = _Entry(kind, head, graph, copy_in, refs,
                                    launches, unpack)
        return outs


__all__ = ["BodyIO", "CudaCapture", "DispatchIO", "GlueIO", "GraphCache",
           "KINDS", "copy_each",
           "flatten", "unflatten", "write_outputs"]
