"""Telemetry of the serving loop: spans, request lifecycles and gauge logs.

One recorder for the process (``RECORDER``), as ``coalesced_gemm.
launches_by_shape`` is one counter for the process, so that a benchmark's
reader finds the records after the engine that made them is freed. Every
stamp is ``time.monotonic()``: the host clock a harness times requests
and tokens with. Each kind of record lives in a bounded ring, so a daemon
that runs for days holds a fixed amount.

* **Spans** (``span(name)``): name, start, end, the enclosing
  span's uid and attributes. Recorded only while tracing is on: by
  default while a ``torch.profiler`` records (the serving loop calls
  ``refresh()`` once a pass to look), always after ``enable()``, never
  after ``disable()`` (``follow_profiler()`` restores the default). While
  a profiler records, a top-level span also opens a profiler range under
  its name (``_profiler_range``), so it lies among the profiler's host
  events on the device trace's clock. With tracing off a span site costs
  one flag check and gets the shared no-op ``NO_SPAN`` (falsy, so a site
  skips building attributes with ``if sp:``).
* **Device time of a body** (``body(kind, like)``): while tracing, on a
  CUDA tensor's device, a pair of CUDA events around the body on the
  current stream. ``resolve()`` reads the pairs that have completed,
  without a synchronize of its own (the serving loop calls it after each
  token read-back, which has synchronised), into the innermost span that
  was open around the body, as ``device_ms``: a list of (kind, ms).
* **Request lifecycles** (``polled(rid, tenant)``): always on, one
  ``RequestLife`` a request, keyed by the id the door saw, stamped O(1) at
  each transition by the serving engine: polled, admitted, the seconds it
  waited while its tenant had no free slot (``SlotClock``), retired.
* **Gauges** (``gauge(name, key, value, total)``): always on, a change log
  — one entry a change of value, never one a pass: ``"slots"`` (a
  tenant's occupied decode slots, of ``total``) and ``"waiting"`` (a
  device's waiting requests).

Spans are opened on the serving loop's thread only.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import math
import time
from typing import Any, Container, Deque, List, Optional, Tuple

import torch

now = time.monotonic

SPAN_CAPACITY = 1 << 16
REQUEST_CAPACITY = 1 << 16
GAUGE_CAPACITY = 1 << 17


class _NoSpan(int):
    """What a span site gets while tracing is off: it records nothing. An
    ``int`` (0), so that ``if sp:`` costs no Python call."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None

    def set(self, **attrs) -> None:
        pass


NO_SPAN = _NoSpan(0)


def _profiler_range(name: str):
    """A profiler range of function scope: a host event only. The
    user scope of ``torch.profiler.record_function`` would also lay a
    ``gpu_user_annotation`` over the device work launched inside it, on
    the device timeline, where a reader of device time counts it as
    device work."""
    return torch._C._profiler._RecordFunctionFast(name)


class Span:
    """One recorded interval of the loop (see the module docstring)."""

    __slots__ = ("uid", "name", "t0", "t1", "parent", "attrs", "_rec",
                 "_rf")

    def __init__(self, rec: "Recorder", name: str, attrs: dict):
        self.uid = next(rec._uids)
        self.name = name
        self.attrs = attrs
        self.parent: Optional[int] = None
        self.t0 = self.t1 = math.nan
        self._rec = rec
        self._rf = None

    def __enter__(self) -> "Span":
        rec = self._rec
        if rec._stack:
            self.parent = rec._stack[-1].uid
        elif rec.profiling:
            self._rf = _profiler_range(self.name)
        # the stamps lie next to the profiler's own (inside the range's
        # enter and exit)
        self.t0 = now()
        if self._rf is not None:
            self._rf.__enter__()
        rec._stack.append(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._rf is not None:
            self._rf.__exit__(exc_type, exc, tb)
        self.t1 = now()
        self._rf = None
        rec = self._rec
        rec._stack.pop()
        rec.spans.append(self)

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)


class _Body:
    """A pair of CUDA events around one body (``Recorder.body``)."""

    __slots__ = ("rec", "kind", "device", "start")

    def __init__(self, rec: "Recorder", kind: str, device: torch.device):
        self.rec, self.kind, self.device = rec, kind, device

    def __enter__(self) -> "_Body":
        self.start = self.rec._event(self.device)
        self.start.record()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        end = self.rec._event(self.device)
        end.record()
        self.rec._pending.append((self.rec._stack[-1], self.kind,
                                  self.start, end, self.device))


@dataclasses.dataclass(slots=True)
class RequestLife:
    """One request's passage through the loop, on the host clock: polled
    (routed to its device), admitted (it left the waiting list with a
    prefill program declared, or ``_admit`` began), retired (its last
    token). ``wait_slots``: seconds of its wait during which its tenant
    had no free decode slot."""
    rid: int
    tenant: str
    polled: float
    admitted: float = math.nan
    retired: float = math.nan
    wait_slots: float = 0.0
    # the tenant's SlotClock reading when the request began to wait
    mark: float = 0.0


class SlotClock:
    """Running seconds one tenant has had no free decode slot. A waiting
    request's slot wait is the difference of two readings, so the engine
    keeps one clock a tenant, not one a waiting request."""

    __slots__ = ("full", "since", "total")

    def __init__(self) -> None:
        self.full = False
        self.since = self.total = 0.0

    def reading(self, t: float) -> float:
        return self.total + (t - self.since if self.full else 0.0)

    def set(self, full: bool, t: float) -> None:
        if full != self.full:
            self.total = self.reading(t)
            self.full, self.since = full, t


class Recorder:
    """The process's spans, request lifecycles and gauge logs."""

    def __init__(self) -> None:
        self.spans: Deque[Span] = collections.deque(maxlen=SPAN_CAPACITY)
        self.requests: "collections.OrderedDict[int, RequestLife]" = \
            collections.OrderedDict()
        # (t, name, key, value, total)
        self.gauges: Deque[Tuple[float, str, Any, int, int]] = \
            collections.deque(maxlen=GAUGE_CAPACITY)
        # None: trace while a profiler records; True / False: always / never
        self.forced: Optional[bool] = None
        self.profiling = False
        self.tracing = False
        self._stack: List[Span] = []
        self._uids = itertools.count(1)
        self._pending: List[Tuple[Span, str, Any, Any, Any]] = []
        # per device, timing CUDA events read and free again
        self._events: dict = collections.defaultdict(list)

    # -- the switch -----------------------------------------------------
    def refresh(self, start: bool = False) -> bool:
        """Look whether a profiler records (the loop calls this once a
        pass, with ``start`` as it starts); returns whether tracing is on.
        As a profiler is found (or found at a loop's start), a zero-length
        ``telemetry.on`` event opens its host events: the first event of a
        profiling session pays the profiler's set-up (0.1-1.6 ms on the
        CPU), which would shift the first span against its profiler
        event."""
        profiling = torch._C._autograd._profiler_enabled()
        if profiling and (start or not self.profiling):
            with _profiler_range("telemetry.on"):
                pass
        self.profiling = profiling
        self.tracing = self.profiling if self.forced is None \
            else self.forced
        return self.tracing

    def enable(self) -> None:
        self.forced = True
        self.refresh()

    def disable(self) -> None:
        self.forced = False
        self.refresh()

    def follow_profiler(self) -> None:
        self.forced = None
        self.refresh()

    # -- spans ----------------------------------------------------------
    def span(self, name: str):
        """A span to open with ``with``; its attributes are ``set`` on it
        (behind ``if sp:``, so a site with tracing off builds none)."""
        if not self.tracing:
            return NO_SPAN
        return Span(self, name, {})

    def body(self, kind: str, like: torch.Tensor):
        """Device time of the body run inside (see the module docstring);
        ``like`` is a tensor on the body's device."""
        if not self.tracing or not self._stack or not like.is_cuda:
            return NO_SPAN
        return _Body(self, kind, like.device)

    def _event(self, device: torch.device):
        """A timing CUDA event of ``device``: one read before, else a new
        one (a body then creates none)."""
        free = self._events[device]
        return free.pop() if free else torch.cuda.Event(enable_timing=True)

    def resolve(self) -> None:
        """Move the completed event pairs' times onto their spans."""
        if not self._pending:
            return
        keep = []
        for pair in self._pending:
            sp, kind, start, end, device = pair
            if end.query():
                sp.attrs.setdefault("device_ms", []).append(
                    (kind, start.elapsed_time(end)))
                self._events[device] += (start, end)
            else:
                keep.append(pair)
        self._pending = keep

    def spans_in(self, t0: float, t1: float) -> List[Span]:
        """The finished spans that started in [t0, t1], by start, their
        device times resolved as far as the device has got."""
        self.resolve()
        return sorted((s for s in self.spans if t0 <= s.t0 <= t1),
                      key=lambda s: s.t0)

    # -- request lifecycles and gauges ------------------------------------
    def polled(self, rid: int, tenant: str) -> RequestLife:
        """A new lifecycle record (a later request with the same id
        replaces the earlier one)."""
        life = RequestLife(rid, tenant, now())
        reqs = self.requests
        reqs.pop(rid, None)
        reqs[rid] = life
        if len(reqs) > REQUEST_CAPACITY:
            reqs.popitem(last=False)
        return life

    def gauge(self, name: str, key: Any, value: int, total: int = 0,
              t: Optional[float] = None) -> None:
        """Log gauge ``name``'s new value for ``key`` (at ``t``, by default
        now)."""
        self.gauges.append((now() if t is None else t, name, key, value,
                            total))

    def gauge_seconds(self, name: str, t0: float, t1: float,
                      keys: Optional[Container] = None
                      ) -> Tuple[float, float]:
        """(value-seconds, total-seconds) of gauge ``name`` over [t0, t1],
        summed over its keys (those in ``keys`` when given), each key
        holding its last logged value until its next entry."""
        val = tot = 0.0
        last = {}
        for t, n, key, value, total in self.gauges:
            if n != name or (keys is not None and key not in keys):
                continue
            if t > t1:
                break
            if key in last:
                ta, v, c = last[key]
                dt = t - max(ta, t0)
                if dt > 0:
                    val, tot = val + v * dt, tot + c * dt
            last[key] = (t, value, total)
        for ta, v, c in last.values():
            dt = t1 - max(ta, t0)
            if dt > 0:
                val, tot = val + v * dt, tot + c * dt
        return val, tot


RECORDER = Recorder()

refresh = RECORDER.refresh
enable = RECORDER.enable
disable = RECORDER.disable
follow_profiler = RECORDER.follow_profiler
span = RECORDER.span
body = RECORDER.body
resolve = RECORDER.resolve
gauge = RECORDER.gauge
polled = RECORDER.polled

__all__ = ["NO_SPAN", "RECORDER", "Recorder", "RequestLife", "SlotClock",
           "Span", "body", "disable", "enable", "follow_profiler", "gauge",
           "now", "polled", "refresh", "resolve", "span"]
