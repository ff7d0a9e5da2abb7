"""Schedule traces and the hazard-violation taxonomy.

This module is the dependency-free data layer shared by the runtime
(``JitSession`` records a ``ScheduleTrace``; ``SuperkernelExecutor`` raises
``OperandIdentityHazard`` on a bad shared-operand dispatch) and the static
analyses (``analysis/certify.py`` replays a trace and re-derives the
legality of every OoO decision). It lives in ``core`` — below both — so
neither layer imports the other.

A ``ScheduleTrace`` is the OoO JIT's audit log: program admissions,
per-superkernel group membership with per-op ``(stream, prog_uid, tag,
seq)`` identity, stagger/WAIT events, and the engine-level request
lifecycle (admit / retire / evict / unfinished). It is lightweight by
construction — tuples of ids, keys and floats, never arrays — so recording
it per tick costs O(group size) appends.

Hazard classes (the certifier's rejection taxonomy; see
``analysis/__init__.py`` for the full discussion):

  * ``ProgramOrderHazard``   — per-stream program order broken: an op ran
    before its predecessor in the same program, or two ops of one stream
    were packed into a single (concurrent) superkernel group.
  * ``KVAliasHazard``        — two ops in one coalesced group belong to
    programs whose declared KV-cache write sets overlap (same cache
    owner + slot): concurrent writers to one KV row.
  * ``EnvAliasHazard``       — two ops in one group write the same key of
    the SAME program environment (programs are supposed to have private
    envs; a shared env dict aliases every key in it).
  * ``OperandIdentityHazard``— the shared-operand dispatch regime
    (``clustering.shared_weight_key``) packed ops whose weight closures
    resolve to DIFFERENT arrays: one weight load would silently serve the
    wrong tenant.
  * ``DeadlineHazard``       — EDF bookkeeping broke monotonicity: within
    one program, ``latest_start_t`` must be non-decreasing in program
    order (the remaining critical path only shrinks) and the program
    deadline must stay constant across its ops.
  * ``ConservationHazard``   — request accounting does not balance: an
    admitted request neither retired, was evicted, nor surfaced in
    ``ServeReport.unfinished``; or a request retired/was admitted more
    than once.
  * ``PlacementHazard``      — multi-device placement broke: a coalesced
    group mixed ops assigned to different devices, or an op was
    dispatched on a device other than its admission-time assignment.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Set, Tuple


class HazardViolation(Exception):
    """Base class for every certified-schedule violation.

    ``detail`` carries the offending edge/record as data (machine
    readable); the message is the human rendering of the same facts.
    """

    kind = "hazard"

    def __init__(self, message: str, detail: Any = None):
        super().__init__(message)
        self.detail = detail


class ProgramOrderHazard(HazardViolation):
    kind = "program-order"


class KVAliasHazard(HazardViolation):
    kind = "kv-alias"


class EnvAliasHazard(HazardViolation):
    kind = "env-alias"


class OperandIdentityHazard(HazardViolation):
    kind = "operand-identity"


class DeadlineHazard(HazardViolation):
    kind = "deadline"


class ConservationHazard(HazardViolation):
    kind = "conservation"


class PlacementHazard(HazardViolation):
    kind = "placement"


@dataclasses.dataclass
class OpRecord:
    """One op's identity inside a dispatched superkernel group.

    ``env_id`` qualifies ``env_writes``: env keys are program-private, so
    a cross-program collision is only real when the env OBJECT is shared.
    ``weight_id`` is the identity (ids) of the array(s) the op's weight
    closure resolved to at dispatch time — what the operand-sharing check
    compares, since equal weight KEYS are supposed to imply identical
    arrays."""

    op_id: int
    stream: int
    prog_uid: int
    tag: str
    seq: int
    op_kind: str                          # "decode" | "prefill"
    deadline_t: float
    latest_start_t: float
    weight_key: Optional[Tuple]
    weight_id: Optional[Tuple]
    kv_writes: Tuple = ()                 # (("kv", owner, slot), ...)
    env_writes: Tuple = ()                # declared write keys, or ("*",)
    env_id: int = 0
    device: int = 0                       # admission-time device placement


@dataclasses.dataclass
class DispatchRecord:
    """One superkernel dispatch: the coalesced group at virtual time t.

    ``device`` is where the group actually launched — the certifier's
    placement check requires every member op's assigned device to equal
    it (a group can neither mix devices nor run somewhere else)."""

    t: float
    ops: Tuple[OpRecord, ...]
    shared_operand: bool = False
    device: int = 0


@dataclasses.dataclass
class ProgramAdmit:
    """One program joining the live pool (decode step or prefill pass)."""

    prog_uid: int
    stream: int
    kind: str
    req_ids: Tuple[int, ...] = ()
    kv_writes: Tuple = ()
    device: int = 0                       # admission-time device placement


@dataclasses.dataclass
class ScheduleTrace:
    """The audit log one ``JitSession`` (plus its serving engine) emits.

    The session records ``prog_admits`` / ``dispatches`` / ``waits``; the
    serving engine — which owns the request lifecycle — records
    ``req_admits`` / ``req_retires`` and fills ``evicted`` / ``unfinished``
    when the run ends. Raw ``VLIWJit`` sessions leave the request-level
    fields empty, which the conservation check treats as vacuously
    balanced."""

    prog_admits: List[ProgramAdmit] = dataclasses.field(default_factory=list)
    dispatches: List[DispatchRecord] = dataclasses.field(default_factory=list)
    waits: List[float] = dataclasses.field(default_factory=list)
    # engine-level request lifecycle
    req_admits: List[Tuple[int, float]] = dataclasses.field(
        default_factory=list)          # (req_id, t)
    req_retires: List[Tuple[int, float]] = dataclasses.field(
        default_factory=list)          # (req_id, t)
    evicted: Set[int] = dataclasses.field(default_factory=set)
    unfinished: Set[int] = dataclasses.field(default_factory=set)
    # multi-device request placement: which device each request was
    # admitted on / retired from. Kept as separate dicts (not widened
    # tuples in req_admits/req_retires) so single-device consumers of the
    # 2-tuple schema are untouched; the per-device conservation check
    # requires retire_devices[r] == req_devices[r] for every request.
    req_devices: dict = dataclasses.field(default_factory=dict)
    retire_devices: dict = dataclasses.field(default_factory=dict)
