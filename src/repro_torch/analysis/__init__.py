"""Static dependence analysis and schedule certification for the port's
OoO VLIW JIT (the counterpart of the JAX package's ``analysis``).

The JIT reorders aggressively — EDF anchoring, stagger/WAIT, cross-tenant
superkernel coalescing, shared-operand collapsing — and every reordering
is only legal because of invariants the runtime maintains implicitly (one
live op per stream, private program envs, per-tenant KV slots, weight keys
that really name one tensor). This package makes them machine-checkable:

``analysis.depgraph``
    Static read/write-set dependence analysis per ``KernelProgram``: the
    RAW/WAR/WAW edges between the declared ``reads``/``writes`` of its
    stages, plus cross-program KV-slot/env aliasing constraints.

``analysis.certify``
    Dynamic schedule certification. ``JitSession(record_trace=True)``
    records a ``ScheduleTrace``; the certifier replays it and re-derives
    the legality of every out-of-order decision.
    ``ServingEngine(certify=True)`` runs the incremental certifier per
    tick and raises on the first violation.

``analysis.lint``
    Rule TH002 of the JAX package's linter: plan-cache key functions must
    capture what ``ProgramTemplate.bind`` does not rebind. Runnable as
    ``python -m repro_torch.analysis.lint [path] [--strict] [--json]``.
    The JAX package's TH001 and TH003 police jax tracing and have no
    torch counterpart.

The hazard classes (all ``HazardViolation``s: program order, KV alias, env
alias, operand identity, deadline, conservation, placement) live in
``core/schedtrace.py`` so the runtime can raise them without importing
this package.
"""
from repro_torch.core.schedtrace import (ConservationHazard, DeadlineHazard,
                                         DispatchRecord, EnvAliasHazard,
                                         HazardViolation, KVAliasHazard,
                                         OperandIdentityHazard, OpRecord,
                                         PlacementHazard, ProgramAdmit,
                                         ProgramOrderHazard, ScheduleTrace)
from repro_torch.analysis.certify import (ScheduleCertifier, certify_trace,
                                          check_conservation)
from repro_torch.analysis.depgraph import (DepEdge, DepGraph, build_depgraph,
                                           cross_program_conflicts,
                                           stage_access)

__all__ = [
    "HazardViolation", "ProgramOrderHazard", "KVAliasHazard",
    "EnvAliasHazard", "OperandIdentityHazard", "DeadlineHazard",
    "ConservationHazard", "PlacementHazard", "ScheduleTrace", "OpRecord",
    "DispatchRecord", "ProgramAdmit", "ScheduleCertifier", "certify_trace",
    "check_conservation", "DepEdge", "DepGraph", "build_depgraph",
    "cross_program_conflicts", "stage_access",
]
