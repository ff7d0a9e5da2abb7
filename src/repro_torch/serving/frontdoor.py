"""The serving front door: clocks, tickets and the request intake queue
for ``ServingEngine.serve_forever`` (the long-lived daemon mode).

The port's copy of the JAX package's ``serving/frontdoor.py``, with one
addition: ``next_arrival`` takes a ``where`` filter, so the engine's
lookahead for one mesh device sees only the submissions that can land
there (the JAX package's daemon gives every device the fleet's next
arrival, and a device then waits for a request it will never serve). The
engine does all torch work on the thread that runs ``serve_forever``;
another thread only calls ``submit``, ``close`` and ``stop``.

Replay (``engine.run``) consumes a finite trace and terminates when it is
exhausted; the daemon instead serves whatever arrives at a ``FrontDoor``
until the door is CLOSED, idling (not exiting) while the door is open and
empty, and flushing in-flight work before returning once it closes.

Two clock families drive the loop:

  * ``MonotonicClock`` — the real wall clock (``authoritative=True``): the
    per-device virtual timelines are floored at real elapsed time every
    iteration, so arrival stamps, deadlines and modeled service charges
    share one axis. This is the production daemon.
  * ``VirtualClock`` — a follower clock for tests and the sustained-load
    benchmark: it only ever advances to what the modeled device timelines
    (or an idle sleep) tell it, so a door pre-loaded with a scheduled
    trace replays deterministically, with exactly the per-device clock
    semantics of ``engine.run``.

``FrontDoor.submit`` is thread-safe: a feeder thread may push requests
while the daemon loop runs (``at=None`` stamps the arrival at the poll
that releases it); tests and benches pre-schedule submissions with
``at=t`` instead. Each submission returns a ``Ticket`` that streams the
request's tokens out as they retire (``on_token`` callback or the
``tokens`` list) — the per-request streaming surface of the daemon.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.serving.workload import ServeRequest


class MonotonicClock:
    """Real wall clock, zeroed at construction. Authoritative: device
    virtual timelines are floored at ``now()`` so modeled charges accrue
    on top of real elapsed time."""

    authoritative = True

    def __init__(self) -> None:
        self._t0 = time.monotonic()

    def now(self) -> float:
        return time.monotonic() - self._t0

    def sleep_until(self, t: float) -> None:
        # capped sleep: a feeder thread may submit (or close the door)
        # while we wait, so never commit to a long uninterruptible nap
        dt = t - self.now()
        if dt > 0.0:
            time.sleep(min(dt, 0.05))

    def advance_to(self, t: float) -> None:
        """No-op: real time advances itself."""


class VirtualClock:
    """Deterministic follower clock (tests / benches): ``advance_to``
    tracks the modeled device timelines, ``sleep_until`` jumps idle time
    instantly. Never moves backwards."""

    authoritative = False

    def __init__(self, t: float = 0.0) -> None:
        self.t = t

    def now(self) -> float:
        return self.t

    def sleep_until(self, t: float) -> None:
        self.t = max(self.t, t)

    def advance_to(self, t: float) -> None:
        self.t = max(self.t, t)


@dataclasses.dataclass
class Ticket:
    """Per-request streaming handle returned by ``FrontDoor.submit``."""

    request: ServeRequest
    on_token: Optional[Callable[[int, float], None]] = None
    tokens: List[int] = dataclasses.field(default_factory=list)

    @property
    def shed(self) -> bool:
        return self.request.shed

    @property
    def done(self) -> bool:
        """Finished OR shed — either way the door owes nothing further."""
        return self.request.shed or not math.isnan(self.request.finish_t)


class DoorClosed(RuntimeError):
    """Raised by ``submit`` after the door has closed."""


class FrontDoor:
    """Thread-safe request intake for the serving daemon.

    Lifecycle: ``submit`` requests (live, or pre-scheduled with ``at=``),
    then ``close()`` (or construct the closing time up front with
    ``close(at=...)``). Submissions accepted before closing are always
    honored — closing stops NEW intake; the daemon drains what was
    accepted, flushes in-flight work and returns. ``stop()`` (from any
    thread) closes the door and has the daemon return at its next pass
    without draining.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # (release time, submit seq, request); -inf = release on next poll
        self._heap: List[Tuple[float, int, ServeRequest]] = []
        self._seq = 0
        self._closed = False
        self._stopped = False
        self.close_at: Optional[float] = None
        self.tickets: Dict[int, Ticket] = {}

    # -- intake --------------------------------------------------------
    def submit(self, req: ServeRequest, *, at: Optional[float] = None,
               on_token: Optional[Callable[[int, float], None]] = None
               ) -> Ticket:
        """Queue ``req`` for admission. ``at=None`` releases it at the
        next daemon poll (arrival stamped then); ``at=t`` schedules the
        arrival at clock time ``t``. Returns the request's ``Ticket``."""
        with self._lock:
            if self._closed:
                raise DoorClosed("front door is closed")
            if req.req_id in self.tickets:
                raise ValueError(
                    f"duplicate req_id {req.req_id} at the door — request "
                    f"ids key prompt synthesis and retirement accounting")
            ticket = Ticket(req, on_token=on_token)
            self.tickets[req.req_id] = ticket
            heapq.heappush(self._heap,
                           (at if at is not None else -math.inf,
                            self._seq, req))
            self._seq += 1
            return ticket

    def close(self, at: Optional[float] = None) -> None:
        """Stop accepting new submissions. ``at=t`` defers the closing to
        clock time ``t`` (already-accepted scheduled submissions are still
        released either way)."""
        with self._lock:
            if at is None:
                self._closed = True
            else:
                self.close_at = at if self.close_at is None \
                    else min(self.close_at, at)

    def stop(self) -> None:
        """Close the door and stop serving: the daemon leaves its loop at
        its next pass without draining (what it had not finished stays
        unfinished in its report)."""
        with self._lock:
            self._closed = True
            self._stopped = True

    @property
    def stopped(self) -> bool:
        return self._stopped

    # -- daemon side ---------------------------------------------------
    def poll(self, now: float) -> List[ServeRequest]:
        """Release every submission due at clock time ``now``, stamping
        un-scheduled ones with ``arrival_t = now``."""
        out: List[ServeRequest] = []
        with self._lock:
            if self.close_at is not None and now >= self.close_at:
                self._closed = True
            while self._heap and self._heap[0][0] <= now:
                at, _, req = heapq.heappop(self._heap)
                req.arrival_t = at if math.isfinite(at) else now
                out.append(req)
        return out

    def next_arrival(self, now: float,
                     where: Optional[Callable[[ServeRequest], bool]] = None
                     ) -> Optional[float]:
        """Earliest scheduled release still queued (None if empty; ``now``
        if that is an unscheduled live submission, which is due NOW).
        ``where`` restricts it to the submissions it accepts (the engine
        asks per mesh device)."""
        with self._lock:
            if where is None:
                ats = [self._heap[0][0]] if self._heap else []
            else:
                ats = [at for at, _, req in self._heap if where(req)]
            if not ats:
                return None
            at = min(ats)
            return at if math.isfinite(at) else now

    def closed(self, now: float) -> bool:
        with self._lock:
            # a deferred close LATCHES once any clock-bearing caller
            # observes the deadline passed — submit() has no clock, so the
            # latch is what makes it start refusing
            if self.close_at is not None and now >= self.close_at:
                self._closed = True
            return self._closed

    def drained(self) -> bool:
        with self._lock:
            return not self._heap

    def finished(self, now: float) -> bool:
        """Closed AND drained: the daemon may flush and return."""
        return self.closed(now) and self.drained()

    # -- streaming sink (wired as the engine's token_sink) -------------
    def deliver(self, req: ServeRequest, tok: int, t: float) -> None:
        ticket = self.tickets.get(req.req_id)
        if ticket is None:
            return
        ticket.tokens.append(tok)
        if ticket.on_token is not None:
            ticket.on_token(tok, t)
