"""Schedule certifier: verify every OoO reordering a trace records.

The port's copy of the JAX package's ``analysis/certify.py``, over the
port's copy of ``core/schedtrace.py``.

The scheduler is free to reorder across streams, stagger dispatches and
coalesce cross-tenant groups — but only within the legality envelope the
runtime's invariants define. The certifier re-derives that envelope from a
``ScheduleTrace`` (see ``core/schedtrace.py``) with no access to the
scheduler's internals, so a scheduler bug cannot vouch for itself:

  per-op checks (every dispatched op)
    * program order  — within one ``(stream, prog_uid)`` the ``seq``
      index is strictly increasing, and a stream never resumes a program
      it already moved past (two step programs of one stream must not
      interleave);
    * deadline       — within one program the deadline is constant and
      ``latest_start_t`` is non-decreasing in program order (the
      remaining GEMM-suffix critical path only shrinks).

  per-group checks (every coalesced superkernel)
    * placement      — every op in the group is assigned to the device
      the group dispatched on (a group can neither mix devices nor run
      on a device other than its ops' admission-time placement);
    * concurrency    — no two ops of one stream in one group (they would
      execute "simultaneously" against an intra-stream dependence);
    * KV aliasing    — no two ops whose programs declare overlapping
      KV-cache write sets (same owner + slot);
    * env aliasing   — no two ops writing the same key of the same env
      OBJECT (undeclared stages alias everything via ``"*"``);
    * operand identity — a shared-operand dispatch
      (``shared_weight_key``) requires every op's weight closure to have
      resolved to the identical array(s).

  whole-trace checks (run end)
    * conservation   — every admitted request retires, is evicted
      (exactly once), or surfaces unfinished; nothing is admitted or
      retired twice, and nothing retires/evicts/underfinishes without
      having been admitted.

``ScheduleCertifier`` is incremental — ``ServingEngine(certify=True)``
feeds it each tick's new ``DispatchRecord``s and it raises the concrete
``HazardViolation`` subclass at the offending dispatch. ``certify_trace``
is the batch wrapper the mutation tests use: full replay, optionally
collecting violations instead of raising.
"""
from __future__ import annotations

import math
from typing import Dict, List, Set, Tuple

from repro_torch.core.schedtrace import (ConservationHazard, DeadlineHazard,
                                         DispatchRecord, EnvAliasHazard,
                                         HazardViolation, KVAliasHazard,
                                         OperandIdentityHazard, OpRecord,
                                         PlacementHazard, ProgramOrderHazard,
                                         ScheduleTrace)

# float tolerance for EDF monotonicity: latest_start_t moves by modeled
# gemm times (~1e-6 s), so absolute 1e-9 cleanly separates real
# regressions from accumulation noise
_TOL = 1e-9


class ScheduleCertifier:
    """Incremental legality checker over a stream of dispatch records.

    ``observe`` verifies one coalesced group against the state built from
    everything before it. With ``raise_on_violation`` (the engine's mode)
    the offending ``HazardViolation`` propagates at the exact tick it
    occurs; without it (the test-replay mode) violations accumulate in
    ``self.violations`` and checking continues.

    ``checks`` counts individual legality predicates evaluated — the
    gating benches assert ``violations == 0`` AND ``checks > 0``, because
    a certifier that silently checked nothing would otherwise read as a
    clean pass.
    """

    def __init__(self, raise_on_violation: bool = True):
        self.raise_on_violation = raise_on_violation
        self.checks = 0
        self.violations: List[HazardViolation] = []
        # program-order state
        self._active: Dict[int, int] = {}       # stream -> live prog_uid
        self._closed: Set[int] = set()          # prog uids moved past
        self._last_seq: Dict[int, int] = {}     # prog_uid -> last seq
        # deadline state
        self._deadline: Dict[int, float] = {}   # prog_uid -> deadline_t
        self._latest: Dict[int, float] = {}     # prog_uid -> last latest_start

    # ------------------------------------------------------------------
    def _emit(self, v: HazardViolation) -> None:
        self.violations.append(v)
        if self.raise_on_violation:
            raise v

    @staticmethod
    def _who(op: OpRecord) -> str:
        return (f"op {op.op_id} ({op.tag}, stream {op.stream}, "
                f"prog {op.prog_uid}, seq {op.seq})")

    # ------------------------------------------------------------------
    def observe(self, d: DispatchRecord) -> None:
        """Certify one dispatched superkernel group."""
        self._check_placement(d)
        self._check_group_concurrency(d)
        self._check_kv_alias(d)
        self._check_env_alias(d)
        self._check_operand_identity(d)
        for op in d.ops:
            self._check_program_order(op, d)
            self._check_deadline(op, d)

    # ------------------------------------------------------------------
    # group-level checks
    # ------------------------------------------------------------------
    def _check_placement(self, d: DispatchRecord) -> None:
        """Every op of the group must be assigned to the device the group
        dispatched on: one superkernel launches on one device, and an op
        must run where admission placed it (its weights live there)."""
        for op in d.ops:
            self.checks += 1
            if op.device != d.device:
                self._emit(PlacementHazard(
                    f"{self._who(op)} assigned to device {op.device} was "
                    f"dispatched in a device-{d.device} group at "
                    f"t={d.t:.6g}",
                    detail={"t": d.t, "op": op.op_id,
                            "devices": (op.device, d.device)}))

    def _check_group_concurrency(self, d: DispatchRecord) -> None:
        seen: Dict[int, OpRecord] = {}
        for op in d.ops:
            self.checks += 1
            prev = seen.get(op.stream)
            if prev is not None:
                self._emit(ProgramOrderHazard(
                    f"two ops of stream {op.stream} coalesced into one "
                    f"concurrent group at t={d.t:.6g}: "
                    f"{self._who(prev)} and {self._who(op)}",
                    detail={"t": d.t, "stream": op.stream,
                            "ops": (prev.op_id, op.op_id)}))
            seen[op.stream] = op

    def _check_kv_alias(self, d: DispatchRecord) -> None:
        owner: Dict[Tuple, OpRecord] = {}
        for op in d.ops:
            self.checks += 1
            for r in op.kv_writes:
                prev = owner.get(r)
                if prev is not None and prev.prog_uid != op.prog_uid:
                    self._emit(KVAliasHazard(
                        f"concurrent KV writers in one group at "
                        f"t={d.t:.6g}: {self._who(prev)} and "
                        f"{self._who(op)} both write {r!r}",
                        detail={"t": d.t, "resource": r,
                                "ops": (prev.op_id, op.op_id)}))
                owner[r] = op

    def _check_env_alias(self, d: DispatchRecord) -> None:
        # env keys only alias when the env OBJECT is shared; within one
        # dispatch both envs are live, so id() comparison is sound here
        by_env: Dict[int, List[OpRecord]] = {}
        for op in d.ops:
            self.checks += 1
            for prev in by_env.get(op.env_id, ()):
                if prev.prog_uid == op.prog_uid:
                    continue
                a, b = set(prev.env_writes), set(op.env_writes)
                shared = (a & b) or ({"*"} if ("*" in a or "*" in b) else
                                     set())
                if shared:
                    self._emit(EnvAliasHazard(
                        f"concurrent writers to shared env keys "
                        f"{sorted(shared, key=repr)!r} at t={d.t:.6g}: "
                        f"{self._who(prev)} and {self._who(op)}",
                        detail={"t": d.t, "keys": tuple(shared),
                                "ops": (prev.op_id, op.op_id)}))
            by_env.setdefault(op.env_id, []).append(op)

    def _check_operand_identity(self, d: DispatchRecord) -> None:
        if not d.shared_operand or not d.ops:
            return
        self.checks += 1
        ident = d.ops[0].weight_id
        for op in d.ops[1:]:
            if op.weight_id != ident:
                self._emit(OperandIdentityHazard(
                    f"shared-operand group at t={d.t:.6g} spans distinct "
                    f"weight arrays: {self._who(d.ops[0])} has identity "
                    f"{ident} but {self._who(op)} has {op.weight_id} "
                    f"(key {op.weight_key!r})",
                    detail={"t": d.t, "key": op.weight_key,
                            "ids": (ident, op.weight_id)}))

    # ------------------------------------------------------------------
    # per-op checks
    # ------------------------------------------------------------------
    def _check_program_order(self, op: OpRecord, d: DispatchRecord) -> None:
        if op.prog_uid == 0:        # raw op stream: no program identity
            return
        self.checks += 1
        active = self._active.get(op.stream)
        if active != op.prog_uid:
            if op.prog_uid in self._closed:
                self._emit(ProgramOrderHazard(
                    f"stream {op.stream} resumed program {op.prog_uid} "
                    f"after moving past it: {self._who(op)} dispatched at "
                    f"t={d.t:.6g} interleaves two step programs",
                    detail={"t": d.t, "stream": op.stream,
                            "prog_uid": op.prog_uid, "op": op.op_id}))
            if active is not None:
                self._closed.add(active)
            self._active[op.stream] = op.prog_uid
        last = self._last_seq.get(op.prog_uid)
        if last is not None and op.seq <= last:
            self._emit(ProgramOrderHazard(
                f"program order broken in prog {op.prog_uid}: "
                f"{self._who(op)} dispatched at t={d.t:.6g} after seq "
                f"{last} already ran",
                detail={"t": d.t, "prog_uid": op.prog_uid,
                        "seq": (last, op.seq), "op": op.op_id}))
        self._last_seq[op.prog_uid] = op.seq

    def _check_deadline(self, op: OpRecord, d: DispatchRecord) -> None:
        if op.prog_uid == 0:
            return
        self.checks += 1
        dl = self._deadline.get(op.prog_uid)
        if dl is not None and not (
                op.deadline_t == dl
                or (math.isinf(dl) and math.isinf(op.deadline_t))
                or abs(op.deadline_t - dl) <= _TOL):
            self._emit(DeadlineHazard(
                f"deadline drifted within prog {op.prog_uid}: "
                f"{self._who(op)} carries deadline {op.deadline_t!r} but "
                f"the program dispatched with {dl!r}",
                detail={"prog_uid": op.prog_uid,
                        "deadlines": (dl, op.deadline_t)}))
        self._deadline[op.prog_uid] = op.deadline_t
        prev = self._latest.get(op.prog_uid)
        if prev is not None and op.latest_start_t < prev - _TOL:
            self._emit(DeadlineHazard(
                f"latest_start_t regressed within prog {op.prog_uid}: "
                f"{self._who(op)} has latest_start {op.latest_start_t!r} "
                f"< predecessor's {prev!r} (the remaining critical path "
                f"can only shrink)",
                detail={"prog_uid": op.prog_uid,
                        "latest_start": (prev, op.latest_start_t)}))
        self._latest[op.prog_uid] = op.latest_start_t


def check_conservation(trace: ScheduleTrace,
                       raise_on_violation: bool = True
                       ) -> List[HazardViolation]:
    """Balance the request lifecycle: admitted = retired ∪ evicted ∪
    unfinished, with exactly-once admission/retirement.

    The sets may overlap — an evicted (SLO-demoted) request still
    executes opportunistically and retires — so this is a coverage check,
    not a partition check. Raw traces with no request records are
    vacuously balanced.
    """
    violations: List[HazardViolation] = []

    def emit(v: HazardViolation) -> None:
        violations.append(v)
        if raise_on_violation:
            raise v

    admits = [r for r, _ in trace.req_admits]
    admitted = set(admits)
    if len(admits) != len(admitted):
        dupes = sorted({r for r in admitted if admits.count(r) > 1})
        emit(ConservationHazard(
            f"requests admitted more than once: {dupes}",
            detail={"duplicates": dupes}))
    retires = [r for r, _ in trace.req_retires]
    retired = set(retires)
    if len(retires) != len(retired):
        dupes = sorted({r for r in retired if retires.count(r) > 1})
        emit(ConservationHazard(
            f"requests retired more than once: {dupes}",
            detail={"duplicates": dupes}))
    for name, s in (("retired", retired), ("evicted", set(trace.evicted)),
                    ("unfinished", set(trace.unfinished))):
        ghosts = sorted(s - admitted)
        if ghosts:
            emit(ConservationHazard(
                f"{name} requests never admitted: {ghosts}",
                detail={"set": name, "requests": ghosts}))
    lost = sorted(admitted - retired - set(trace.evicted)
                  - set(trace.unfinished))
    if lost:
        emit(ConservationHazard(
            f"admitted requests neither retired, evicted nor reported "
            f"unfinished: {lost}", detail={"requests": lost}))
    # per-device conservation (multi-device meshes): a request must retire
    # on the device it was admitted to — its KV cache and weights live
    # there, so a cross-device retire means the placement binding broke
    # mid-flight. Traces without device records are vacuously balanced.
    strays = sorted(
        (r, trace.req_devices[r], trace.retire_devices[r])
        for r in set(trace.req_devices) & set(trace.retire_devices)
        if trace.req_devices[r] != trace.retire_devices[r])
    if strays:
        emit(PlacementHazard(
            f"requests retired on a device other than their admission "
            f"placement (req, admitted, retired): {strays}",
            detail={"requests": strays}))
    return violations


def certify_trace(trace: ScheduleTrace, raise_on_violation: bool = True
                  ) -> ScheduleCertifier:
    """Full-trace replay: every dispatch through a fresh incremental
    certifier, then the whole-trace conservation check. Returns the
    certifier (``checks`` and ``violations`` populated); with
    ``raise_on_violation`` the first violation raises instead."""
    cert = ScheduleCertifier(raise_on_violation=raise_on_violation)
    for d in trace.dispatches:
        cert.observe(d)
    cert.checks += 1
    cert.violations.extend(
        check_conservation(trace, raise_on_violation=raise_on_violation))
    return cert
