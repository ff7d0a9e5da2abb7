"""Persistent compiled-plan cache for the OoO JIT hot path.

The paper's premise (§5, after Jain et al., *Dynamic Space-Time Scheduling
for GPU Inference*) is that late-binding scheduling only wins if the
scheduler itself stays off the critical path. Our runtime used to pay an
early-binding tax on every tick: ``build_dense_decode_program`` re-derived
the full stage list for every decode step of every tenant, and the
coalescer re-derived block plans per dispatch. This module is the shared
memoization substrate that retires that tax:

  * **program templates** — ``core/jit.py`` caches compiled
    ``ProgramTemplate``s (stage list + glue closures + weight keys) keyed by
    ``(model identity, active batch m, dtype, cache geometry)`` and rebinds
    only the per-step environment (tokens, KV cache refs, deadlines) via
    ``ProgramTemplate.bind``;
  * **block plans** — the ``Coalescer`` memoizes the superkernel
    grid/block choice + modeled latency per coalesced group signature
    (ordered shape tuple, shared-operand flag).

Invalidation semantics (the cache must never serve a stale plan):

  * **identity guard** — every entry may carry a ``guard`` object (for
    program templates: the ``(model, params)`` pair whose closures the
    template baked in). A lookup whose guard is not the *same object*
    (tuples match element-wise by ``is``) invalidates the entry and
    rebuilds: a weight or model hot-swap therefore can never serve stale
    closures. Guard references are strong on purpose — they pin the old
    objects alive while the entry exists, so a recycled ``id()`` can never
    alias two distinct models or param trees.
  * **group tracking** — a caller may tag lookups with a ``group`` (e.g.
    the tenant name). When the group's key changes — a tenant's active
    batch m changed, its cache was re-geometried — the previous key is
    invalidated immediately (unless another group still uses it) instead
    of lingering until LRU pressure.
  * **LRU capacity bound** — beyond ``capacity`` entries the least
    recently used entry is evicted (counted separately from semantic
    invalidations). ``capacity=0`` disables storage entirely: every
    lookup is a miss and nothing is retained (the "uncached" baseline in
    tests and benchmarks).
  * **LRU byte budget** — with ``byte_capacity`` set, entries also evict
    LRU-first while ``sum(value.nbytes)`` exceeds the budget (values
    without ``nbytes`` count 0, so only array-valued caches — e.g. the
    dispatch executor's packed weights, incl. MoE stacked expert packs —
    are byte-constrained). A value bigger than the whole budget is passed
    through uncached rather than wiping every resident entry.

This module is dependency-free (stdlib only) so every layer of the stack —
coalescer, JIT, serving engine — can import it without cycles.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple


@dataclasses.dataclass
class PlanCacheStats:
    """Counters for one plan cache. Supports ``+``/``-`` so deltas can be
    folded through ``JitStats.merge`` alongside the other run counters."""

    hits: int = 0
    misses: int = 0
    invalidations: int = 0     # guard mismatch / group key change / explicit
    evictions: int = 0         # LRU capacity pressure only

    @property
    def accesses(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.accesses if self.accesses else 0.0

    def copy(self) -> "PlanCacheStats":
        return dataclasses.replace(self)

    def _combine(self, other: "PlanCacheStats", sign: int) -> "PlanCacheStats":
        return PlanCacheStats(
            *(getattr(self, f.name) + sign * getattr(other, f.name)
              for f in dataclasses.fields(self)))

    def __add__(self, other: "PlanCacheStats") -> "PlanCacheStats":
        return self._combine(other, +1)

    def __sub__(self, other: "PlanCacheStats") -> "PlanCacheStats":
        return self._combine(other, -1)


@dataclasses.dataclass
class _Entry:
    value: Any
    guard: Any = None


def _guard_matches(stored: Any, guard: Any) -> bool:
    """Identity match. A tuple guard matches element-wise by ``is`` so a
    caller can guard one entry on several live objects at once (e.g. the
    tenant's model AND params) — the stored tuple pins them all, so none of
    their ids can be recycled while the entry exists."""
    if isinstance(stored, tuple) and isinstance(guard, tuple) \
            and len(stored) == len(guard):
        return all(a is b for a, b in zip(stored, guard))
    return stored is guard


class PlanCache:
    """Capacity-bounded LRU cache with identity-guard and group invalidation.

    ``get_or_build(key, build)`` returns the cached value for ``key`` or
    builds, stores and returns a fresh one. See the module docstring for the
    ``guard`` / ``group`` / ``capacity`` semantics.
    """

    def __init__(self, capacity: int = 128,
                 byte_capacity: Optional[int] = None):
        assert capacity >= 0
        self.capacity = capacity
        # optional LRU budget over sum(value.nbytes): entry-count bounds
        # are meaningless when values are full packed weight copies (one
        # entry can be hundreds of MB at real model sizes). Values without
        # an ``nbytes`` (block plans, templates) count as 0 — the byte
        # budget only constrains array-valued caches.
        self.byte_capacity = byte_capacity
        self.bytes = 0
        self._entries: "OrderedDict[Hashable, _Entry]" = OrderedDict()
        self._group_key: Dict[Hashable, Hashable] = {}
        self.stats = PlanCacheStats()
        # called with each value the cache drops (evicted, invalidated or
        # cleared): the graphs of core/graphs.py that read a dropped packed
        # weight go with it
        self.on_drop: List[Callable[[Any], None]] = []

    def _dropped(self, entry: _Entry) -> None:
        for fn in self.on_drop:
            fn(entry.value)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._entries

    def keys(self):
        return list(self._entries)

    @staticmethod
    def _nbytes(entry: _Entry) -> int:
        return int(getattr(entry.value, "nbytes", 0))

    def _pop(self, key: Hashable) -> Optional[_Entry]:
        entry = self._entries.pop(key, None)
        if entry is not None:
            self.bytes -= self._nbytes(entry)
            self._forget_groups(key)
            self._dropped(entry)
        return entry

    def _forget_groups(self, key: Hashable) -> None:
        """Drop group mappings whose target entry no longer exists —
        otherwise ``_group_key`` grows one tuple per group composition
        ever seen (the hot dispatch path feeds per-group tags), and dead
        mappings slow the key-change scan forever."""
        dead = [g for g, k in self._group_key.items() if k == key]
        for g in dead:
            del self._group_key[g]

    # ------------------------------------------------------------------
    def get_or_build(self, key: Hashable, build: Callable[[], Any], *,
                     guard: Any = None, group: Optional[Hashable] = None
                     ) -> Any:
        return self.get_or_build_flagged(key, build, guard=guard,
                                         group=group)[0]

    def get_or_build_flagged(self, key: Hashable, build: Callable[[], Any], *,
                             guard: Any = None,
                             group: Optional[Hashable] = None
                             ) -> "Tuple[Any, bool]":
        """``get_or_build`` that also reports whether the lookup HIT.

        Callers that account avoided work per access (e.g. the dispatch
        executor's bytes-not-copied counter) need the per-call outcome, not
        just the aggregate stats delta."""
        # capacity 0 stores nothing, so there are no entries for group
        # tracking to invalidate — recording mappings would only leak
        if group is not None and self.capacity == 0:
            group = None
        if group is not None:
            old = self._group_key.get(group)
            if old is not None and old != key:
                # the group's plan shape changed (e.g. batch-size change):
                # its previous entry can never be valid for it again. Only
                # drop it if no other group still resolves to it.
                if not any(k == old for g, k in self._group_key.items()
                           if g != group):
                    if self._pop(old) is not None:
                        self.stats.invalidations += 1
            self._group_key[group] = key
        entry = self._entries.get(key)
        if entry is not None:
            if guard is not None and not _guard_matches(entry.guard, guard):
                # identity guard tripped (weight hot-swap): stale plan
                self._pop(key)
                self.stats.invalidations += 1
                if group is not None:   # _pop swept the mapping set above
                    self._group_key[group] = key
            else:
                self._entries.move_to_end(key)
                self.stats.hits += 1
                return entry.value, True
        self.stats.misses += 1
        value = build()
        if self.capacity > 0:
            entry = _Entry(value, guard)
            if self.byte_capacity is not None \
                    and self._nbytes(entry) > self.byte_capacity:
                # an entry bigger than the WHOLE byte budget can never be
                # retained legally — storing it used to wipe every other
                # entry (each dropped for nothing, since the cache stayed
                # over budget anyway with the giant pinned as "newest").
                # Large MoE expert packs hit this: pass the value through
                # uncached instead, leaving unrelated entries intact.
                return value, False
            self._entries[key] = entry
            self._entries.move_to_end(key)
            self.bytes += self._nbytes(entry)
            while len(self._entries) > self.capacity or (
                    self.byte_capacity is not None
                    and self.bytes > self.byte_capacity
                    and len(self._entries) > 1):   # keep the newest entry
                k, dropped = self._entries.popitem(last=False)
                self.bytes -= self._nbytes(dropped)
                self._forget_groups(k)
                self._dropped(dropped)
                self.stats.evictions += 1
        return value, False

    # ------------------------------------------------------------------
    def peek(self, key: Hashable) -> Any:
        """Read an entry WITHOUT touching stats, LRU order or guards
        (``None`` if absent). For introspection only — bench summaries and
        lifecycle tests read tuned configs through this so observing a
        cache never perturbs the hit-rate acceptance criteria it gates."""
        entry = self._entries.get(key)
        return entry.value if entry is not None else None

    def holds(self, value: Any) -> bool:
        """Whether ``value`` is one of the cached values (by identity),
        without touching stats or LRU order."""
        return any(e.value is value for e in self._entries.values())

    def invalidate(self, key: Hashable) -> bool:
        """Explicitly drop one entry; returns whether it existed."""
        if self._pop(key) is not None:
            self.stats.invalidations += 1
            return True
        return False

    def clear(self) -> None:
        """Drop everything (counted as invalidations)."""
        self.stats.invalidations += len(self._entries)
        entries = list(self._entries.values())
        self._entries.clear()
        self._group_key.clear()
        self.bytes = 0
        for entry in entries:
            self._dropped(entry)
