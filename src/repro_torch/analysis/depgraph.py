"""Static read/write-set dependence graph per ``KernelProgram``.

The port's copy of the JAX package's ``analysis/depgraph.py``: the pass
reads only the stages' declared access sets, so it is framework-neutral.

Every stage the template builders emit declares its access sets (the
``reads``/``writes`` fields on ``GemmStage``/``GlueStage``/
``StackedGemmStage``): env keys like ``"h2"`` or ``("moe_act", e)``, plus
the reserved ``"cache"``/``"new_layers"`` resources for stages touching KV
state. ``None`` means UNDECLARED — the analysis must assume the stage
aliases everything, which serializes it against every neighbor (the
conservative wildcard ``"*"``).

The pass runs last-writer/readers-since bookkeeping over the stage list in
program order and yields the classic dependence edges:

  * RAW — stage j reads a key stage i last wrote (true dependence);
  * WAW — stage j overwrites a key stage i last wrote;
  * WAR — stage j overwrites a key stage i read since its last write
    (anti-dependence).

This is the ground truth the scheduler's program-order rule (one live op
per stream, stages issue strictly in ``pc`` order) over-approximates: the
certifier enforces total per-program order, and this graph proves which of
those orderings are actually load-bearing. It is also the review tool for
the declared sets themselves — a stage whose declared reads can never be
produced (no upstream writer and not a bind-time env binding) is a
declaration bug, surfaced by ``DepGraph.unsourced_reads``.

Cross-program constraints are simpler than intra-program ones — programs
share no env by construction — so ``cross_program_conflicts`` reduces to
declared-KV-slot overlap and env-object identity.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Set, Tuple

# the conservative wildcard: an undeclared stage reads and writes "*"
ALIAS_ALL: Tuple = ("*",)

# env keys bound by ProgramTemplate.bind (or its env_extra) rather than
# written by an upstream stage — legitimate sources for a first read
BIND_TIME_KEYS = frozenset({"tokens", "cache", "new_layers", "real_len",
                            "slot", "req"})


def stage_access(stage: Any) -> Tuple[Tuple, Tuple]:
    """The (reads, writes) access sets of one stage, conservatively
    widened: a ``None`` (undeclared) set becomes the wildcard ``("*",)``.
    Works on any stage flavor — the fields are read via ``getattr`` so
    raw/foreign stage objects degrade to alias-everything instead of
    raising."""
    reads = getattr(stage, "reads", None)
    writes = getattr(stage, "writes", None)
    return (tuple(reads) if reads is not None else ALIAS_ALL,
            tuple(writes) if writes is not None else ALIAS_ALL)


def _stage_label(i: int, stage: Any) -> str:
    tag = getattr(stage, "tag", None)
    if tag:
        return f"{i}:{tag}"
    fn = getattr(stage, "fn", None)
    name = getattr(fn, "__name__", type(stage).__name__)
    return f"{i}:{name}"


@dataclasses.dataclass(frozen=True)
class DepEdge:
    """One dependence edge: stage ``dst`` must not run before ``src``."""

    kind: str                      # "RAW" | "WAR" | "WAW"
    src: int                       # stage index
    dst: int
    resource: Any                  # the aliased key ("*" for conservative)


@dataclasses.dataclass
class DepGraph:
    """The dependence structure of one program's stage list."""

    labels: List[str]              # one per stage, index-aligned
    edges: List[DepEdge]
    conservative: List[int]        # indices of undeclared (wildcard) stages
    # declared reads with no upstream writer and no bind-time binding —
    # either a declaration bug or a genuinely dynamic env protocol
    unsourced_reads: List[Tuple[int, Any]]

    def edges_between(self, src: int, dst: int) -> List[DepEdge]:
        return [e for e in self.edges if e.src == src and e.dst == dst]

    def predecessors(self, i: int) -> Set[int]:
        return {e.src for e in self.edges if e.dst == i}


def build_depgraph(program_or_stages: Any) -> DepGraph:
    """Build the RAW/WAR/WAW graph for a ``KernelProgram`` (or template,
    or bare stage list) by forward last-writer analysis.

    Wildcard semantics: a ``"*"`` read touches every key seen so far; a
    ``"*"`` write clobbers every key (it becomes the last writer of the
    whole env), so undeclared stages act as full barriers.
    """
    stages = getattr(program_or_stages, "stages", program_or_stages)
    labels = [_stage_label(i, st) for i, st in enumerate(stages)]
    edges: Set[DepEdge] = set()
    conservative: List[int] = []
    unsourced: List[Tuple[int, Any]] = []

    last_writer: Dict[Any, int] = {}
    readers_since: Dict[Any, List[int]] = {}
    star_writer: Optional[int] = None      # last "*"-writing stage
    universe: Set[Any] = set()

    def latest_writer(key: Any) -> Optional[int]:
        w = last_writer.get(key)
        if star_writer is None:
            return w
        return star_writer if w is None else max(w, star_writer)

    for i, st in enumerate(stages):
        reads, writes = stage_access(st)
        star_r, star_w = "*" in reads, "*" in writes
        if star_r or star_w:
            conservative.append(i)
        eff_reads = set(universe) if star_r else \
            {k for k in reads if k != "*"}
        eff_writes = (set(universe) | {k for k in writes if k != "*"}) \
            if star_w else {k for k in writes if k != "*"}

        for k in sorted(eff_reads, key=repr):
            w = latest_writer(k)
            if w is not None:
                edges.add(DepEdge("RAW", w, i, k))
            elif k not in BIND_TIME_KEYS and not star_r:
                unsourced.append((i, k))
        for k in sorted(eff_writes, key=repr):
            w = latest_writer(k)
            if w is not None:
                edges.add(DepEdge("WAW", w, i, k))
            floor = -1 if w is None else w
            for r in readers_since.get(k, ()):
                if r > floor and r != i:
                    edges.add(DepEdge("WAR", r, i, k))

        # update state AFTER computing this stage's edges
        for k in eff_reads:
            readers_since.setdefault(k, []).append(i)
        for k in eff_writes:
            last_writer[k] = i
            readers_since[k] = []
        if star_w:
            star_writer = i
            readers_since = {}
        universe |= eff_reads | eff_writes

    ordered = sorted(edges, key=lambda e: (e.dst, e.src, e.kind, repr(e.resource)))
    return DepGraph(labels=labels, edges=ordered,
                    conservative=conservative, unsourced_reads=unsourced)


def cross_program_conflicts(a: Any, b: Any) -> List[Tuple[str, Any]]:
    """Aliasing constraints between two programs' declared footprints —
    the resources that make it ILLEGAL to pack ops of both programs into
    one concurrent superkernel group.

    Programs have private envs by construction, so only two channels can
    alias: declared KV-cache rows (``KernelProgram.kv_writes`` overlap —
    two writers to one owner+slot) and a literally shared env object
    (``a.env is b.env`` — every key aliases). Returns ``("kv", resource)``
    / ``("env", key)`` pairs; empty means the pair is freely coalescible.
    """
    conflicts: List[Tuple[str, Any]] = []
    akv = set(getattr(a, "kv_writes", ()) or ())
    bkv = set(getattr(b, "kv_writes", ()) or ())
    for r in sorted(akv & bkv, key=repr):
        conflicts.append(("kv", r))
    aenv, benv = getattr(a, "env", None), getattr(b, "env", None)
    if aenv is not None and aenv is benv:
        awr: Set[Any] = set()
        bwr: Set[Any] = set()
        for st in getattr(a, "stages", ()):
            awr |= set(stage_access(st)[1])
        for st in getattr(b, "stages", ()):
            bwr |= set(stage_access(st)[1])
        shared = (awr & bwr) or {"*"}
        for k in sorted(shared, key=repr):
            conflicts.append(("env", k))
    return conflicts
