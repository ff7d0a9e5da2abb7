"""Multi-tenant serving engine: event-driven OoO serving with live admission.

The counterpart of the JAX package's ``serving/engine.py`` for one device
and dense, MoE and SSM tenants. Three execution modes, mirroring the
paper's comparison end to end:

  * "time"    — each request decodes alone, requests strictly serialized
                (time-multiplexing, §4.1);
  * "batched" — continuous batching *within* each tenant, tenants serialized
                (§4.2's strongest baseline);
  * "vliw"    — the OoO VLIW engine: one virtual-time event loop over an
                admission-open ``JitSession`` (core/jit.py). Tenants' decode
                steps AND prompt prefills (declared prefill, for prompts of
                at least ``prefill_declare_min`` tokens) are compiled to
                KernelPrograms whose GEMMs coalesce ACROSS tenants into the
                ``coalesced_gemm`` superkernel. A request arriving mid-flight
                joins between superkernel dispatches. The trace's future
                arrival times feed the scheduler's stagger/WAIT branch, and
                each tenant's tightest per-request deadline flows into
                per-op ``latest_start_t``.

Token generation is real (greedy argmax through the actual models, on the
engine's device); time is attributed with the cost model (``H100`` by
default, spec-sheet values), so ``ServeReport.modeled_time_s`` is modelled
and ``wall_time_s`` is the host clock. Greedy tokens are identical across
the three modes because batch rows are independent. An MoE step is the
exception, as in the JAX package: it routes its whole slotted batch as one
group with a per-expert capacity, so a row's tokens can depend on what
its batchmates hold when drops occur.

Arch support in vliw mode, as in the JAX package (the other families raise
``NotImplementedError`` in ``Model``):

  ==========  ================================  ==========================
  arch_type   decode step                       prompt prefill
  ==========  ================================  ==========================
  dense       KernelProgram                     declared prefill program
                                                (>= prefill_declare_min;
                                                analytic below it)
  moe         KernelProgram (router glue +      analytic (``Model.prefill``)
              per-expert GEMMs)
  ssm         KernelProgram (scan recurrence    analytic (``Model.prefill``)
              glue)
  ==========  ================================  ==========================

``JitStats.nondense_programs`` counts the MoE / SSM decode programs
admitted. The baseline modes ("time", "batched") run ``Model.decode_step``
for every family.

Continuous batching: each tenant owns a slotted decode cache (``max_batch``
rows, per-row positions). Admission prefills a request and writes its KV
rows into a free slot; completed requests free their slot mid-flight.
Cache updates are functional (new tensors), as in the JAX package.

Prompts: the JAX package draws them with ``jax.random``; here a CPU
``torch.Generator`` seeded with (seed, req_id) draws them, and a
``prompt_fn(tenant, req) -> LongTensor[1, S]`` hook replaces the draw
(parity tests pass the JAX package's prompts through it).

Tenants compile to layer-stacked templates by default
(``stacked_layers=True``, one body per homogeneous sub-stack of layers, as
in the JAX package); ``stacked_layers=False`` serves the per-layer
emission, the bitwise oracle. Both give the same tokens.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP item
when asked for; the keywords are accepted with the JAX package's defaults):
the schedule certifier (``certify``), admission control (``admission_control``,
``admission``), the real-clock front door (``serve_forever``,
``token_sink``), the modelled mesh (``num_devices > 1``, ``devices``) and
live tuning (``live_tune``, ``tune_objective``).
"""
from __future__ import annotations

import dataclasses
import math
import time as _time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.costmodel import CostModel, H100
from repro_torch.core.jit import (JitStats, KernelProgram, VLIWJit,
                                  build_dense_decode_template,
                                  build_dense_prefill_template,
                                  build_moe_decode_template,
                                  build_ssm_decode_template,
                                  dense_program_cache_key,
                                  moe_program_cache_key, prefill_bucket,
                                  prefill_program_cache_key,
                                  ssm_program_cache_key)
from repro_torch.core.kernelspec import gemm_population
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.models.model import Model
from repro_torch.serving.workload import ServeRequest

PromptFn = Callable[["Tenant", ServeRequest], torch.Tensor]


@dataclasses.dataclass
class Tenant:
    name: str
    model: Model
    params: Any
    cache_len: int = 64
    max_batch: int = 4
    # runtime state
    cache: Any = None
    slot_req: List[Optional[ServeRequest]] = dataclasses.field(
        default_factory=list)
    slot_tok: Any = None
    slot_remaining: List[int] = dataclasses.field(default_factory=list)

    @property
    def cfg(self) -> ModelConfig:
        return self.model.cfg

    def active_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is not None]


@dataclasses.dataclass
class ServeReport:
    mode: str
    requests: List[ServeRequest]
    modeled_time_s: float
    wall_time_s: float
    jit: Optional[JitStats] = None

    @property
    def finished(self) -> List[ServeRequest]:
        return [r for r in self.requests if not np.isnan(r.finish_t)]

    @property
    def unfinished(self) -> int:
        """Requests that never finished (stalled / unadmittable)."""
        return len(self.requests) - len(self.finished)

    @property
    def slo_attainment(self) -> float:
        """Fraction of ALL requests that finished within their SLO
        (unfinished requests count as misses)."""
        n = len(self.requests)
        return sum(r.met_slo for r in self.requests) / max(n, 1)

    @property
    def mean_latency(self) -> float:
        """Mean modeled latency over FINISHED requests only."""
        done = self.finished
        return float(np.mean([r.latency for r in done])) if done \
            else float("nan")

    def p_latency(self, q: float) -> float:
        """Latency quantile over ALL requests: an unfinished request
        contributes +inf; matches np.quantile when every request finished."""
        n = len(self.requests)
        if n == 0:
            return float("nan")
        lats = sorted(r.latency for r in self.finished)
        k = len(lats)
        pos = q * (n - 1)
        lo, hi = int(math.floor(pos)), int(math.ceil(pos))
        if lo >= k:
            return math.inf
        if hi >= k:
            return math.inf if pos > lo else float(lats[lo])
        return float(lats[lo] + (pos - lo) * (lats[hi] - lats[lo]))

    @property
    def tokens_out(self) -> int:
        return sum(len(r.tokens_out or ()) for r in self.requests)

    @property
    def tokens_per_s(self) -> float:
        """Tokens emitted per MODELED second."""
        return self.tokens_out / self.modeled_time_s \
            if self.modeled_time_s else 0.0


@dataclasses.dataclass
class ArrivalPredictor:
    """Per-tenant inter-arrival EWMA: ``observe(tenant, t)`` folds the new
    gap |t - last| into the tenant's EWMA (``alpha`` weights the newest);
    ``predict(now)`` is the earliest expected next arrival across tenants
    (``last + gap``, or ``now + gap`` once that has passed), inf until a gap
    has been seen."""

    alpha: float = 0.2
    _last: Dict[str, float] = dataclasses.field(default_factory=dict)
    _gap: Dict[str, float] = dataclasses.field(default_factory=dict)

    def observe(self, tenant: str, t: float) -> None:
        last = self._last.get(tenant)
        if last is not None:
            gap = abs(t - last)
            prev = self._gap.get(tenant)
            self._gap[tenant] = gap if prev is None else \
                self.alpha * gap + (1.0 - self.alpha) * prev
        self._last[tenant] = max(t, last) if last is not None else t

    def reset(self) -> None:
        """Forget all state (a run's virtual clock restarts at 0)."""
        self._last.clear()
        self._gap.clear()

    def predict(self, now: float) -> float:
        est = math.inf
        for tenant, gap in self._gap.items():
            t_hat = self._last[tenant] + gap
            if t_hat <= now:
                t_hat = now + gap
            est = min(est, t_hat)
        return est


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1 "
                               f"item {item})")


class ServingEngine:
    def __init__(self, tenants: Sequence[Tenant], mode: str = "vliw",
                 cost: Optional[CostModel] = None, max_group: int = 16,
                 sched_cfg: SchedulerConfig = SchedulerConfig(),
                 plan_capacity: int = 128, declared_prefill: bool = True,
                 prefill_declare_min: int = 16,
                 predict_arrivals: bool = False,
                 arrival_alpha: float = 0.2,
                 weight_budget_bytes: Optional[int] = 1 << 30,
                 stacked_layers: bool = True,
                 certify: bool = False,
                 num_devices: int = 1,
                 devices: Optional[Any] = None,
                 live_tune: bool = False,
                 tune_objective: str = "collaborative",
                 admission_control: bool = False,
                 admission: Optional[Any] = None,
                 token_sink: Optional[Any] = None,
                 prompt_fn: Optional[PromptFn] = None,
                 device: DeviceLike = None):
        assert mode in ("time", "batched", "vliw")
        if certify:
            raise _not_ported("certify=True (the schedule certifier)", "11")
        if admission_control or admission is not None:
            raise _not_ported("admission control", "10")
        if token_sink is not None:
            raise _not_ported("token_sink (the front door's token stream)",
                              "10")
        if num_devices != 1 or devices is not None:
            raise _not_ported("the multi-device mesh", "9")
        if live_tune or tune_objective != "collaborative":
            raise _not_ported("live tuning", "14")
        self.tenants = {t.name: t for t in tenants}
        # the device the engine serves on: the current CUDA device unless
        # the caller names one (raises when none is given and CUDA is
        # absent); every tenant's model must live there
        self.device = resolve_device(device)
        for t in tenants:
            if t.model.device != self.device:
                raise ValueError(f"tenant {t.name!r} lives on "
                                 f"{t.model.device}, the engine serves "
                                 f"{self.device}")
        self.mode = mode
        # True: one layer body per homogeneous sub-stack; False: per-layer
        # stages (the bitwise oracle). The analytic charges below do not
        # depend on it: a stacked op is charged as L sequential tile-waves,
        # the total the per-layer stages add up to.
        self.stacked_layers = stacked_layers
        self.declared_prefill = declared_prefill
        # prompts shorter than this stay on the analytic prefill charge
        # (their GEMMs are GEMV-shaped like a decode step's)
        self.prefill_declare_min = prefill_declare_min
        self.predict_arrivals = predict_arrivals
        self._arrival_pred = ArrivalPredictor(alpha=arrival_alpha)
        self.prompt_fn = prompt_fn
        self.cost = cost or CostModel(H100)
        self.jit = VLIWJit(self.cost, sched_cfg=sched_cfg,
                           max_group=max_group, plan_capacity=plan_capacity,
                           weight_budget_bytes=weight_budget_bytes)
        self.jit_stats = JitStats()
        self._seed = 0
        for t in tenants:
            if not self._jit_capable(t):
                raise _not_ported(f"serving arch_type {t.cfg.arch_type!r}",
                                  "12")
            t.cache = t.model.init_cache(t.max_batch, t.cache_len)
            t.slot_req = [None] * t.max_batch
            t.slot_tok = torch.zeros((t.max_batch, 1), dtype=torch.long,
                                     device=self.device)
            t.slot_remaining = [0] * t.max_batch

    def serve_forever(self, *args, **kwargs):
        raise _not_ported("serve_forever (the real-clock front door)", "10")

    # ------------------------------------------------------------------
    # modeled step times
    # ------------------------------------------------------------------
    def _ops_time(self, cfg: ModelConfig, m: int) -> float:
        """Serial modeled time for one full decode step at batch m."""
        t = 0.0
        for tag, shape in gemm_population(cfg, m):
            reps = 1 if tag == "unembed" else cfg.num_layers
            t += reps * self.cost.gemm_time(shape)
        return t + self._attn_time(cfg, m)

    def _attn_time(self, cfg: ModelConfig, m: int) -> float:
        """KV-cache streaming time (memory-bound), same for every mode."""
        if cfg.is_attention_free:
            return 0.0
        hd = cfg.resolved_head_dim
        lens = [t.cache_len for t in self.tenants.values() if t.cfg is cfg]
        mean_len = 0.5 * max(lens) if lens else 64
        bytes_ = 2 * cfg.num_layers * cfg.num_kv_heads * mean_len * hd * 2 * m
        return bytes_ / self.cost.device.hbm_bw

    def _prefill_attn_time(self, cfg: ModelConfig, prompt_len: int) -> float:
        """KV write-back + causal attention streaming for one prompt."""
        if cfg.is_attention_free:
            return 0.0
        hd = cfg.resolved_head_dim
        s = prompt_len
        per_entry = 2 * cfg.num_layers * cfg.num_kv_heads * hd * 2
        return per_entry * (s + s * (s + 1) / 2.0) / self.cost.device.hbm_bw

    def _prefill_time(self, cfg: ModelConfig, prompt_len: int) -> float:
        """Analytic serialized prompt cost: GEMMs + KV/attention traffic."""
        t = 0.0
        for tag, shape in gemm_population(cfg, prompt_len):
            reps = 1 if tag == "unembed" else cfg.num_layers
            t += reps * self.cost.gemm_time(shape)
        return t + self._prefill_attn_time(cfg, prompt_len)

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def _make_prompt(self, tenant: Tenant, req: ServeRequest
                     ) -> torch.Tensor:
        """The request's prompt [1, prompt_len] (int64, on the engine's
        device) — from ``prompt_fn`` when given, else drawn from (seed,
        req_id) only, so every mode and prefill path sees the same tokens."""
        if self.prompt_fn is not None:
            prompt = self.prompt_fn(tenant, req)
        else:
            g = torch.Generator().manual_seed(
                (self._seed * 1_000_003 + req.req_id) & 0x7FFFFFFFFFFFFFFF)
            prompt = torch.randint(0, tenant.cfg.vocab_size,
                                   (1, req.prompt_len), generator=g)
        assert tuple(prompt.shape) == (1, req.prompt_len), prompt.shape
        return prompt.to(device=self.device, dtype=torch.long)

    def _admit(self, tenant: Tenant, req: ServeRequest, now: float) -> float:
        """Prefill ``req`` into the tenant (``Model.prefill``). Returns the
        modeled prefill time (0.0 with ``tokens_out`` still None means: no
        free slot, retry). A request whose prefill produced its only token
        retires here, at admission, without taking a slot."""
        needs_slot = req.max_new_tokens > 1
        slots = [i for i, r in enumerate(tenant.slot_req) if r is None]
        if needs_slot and not slots:
            return 0.0  # caller retries later
        m = tenant.model
        logits, pc = m.prefill(tenant.params,
                               {"tokens": self._make_prompt(tenant, req)},
                               cache_len=tenant.cache_len)
        tok = int(torch.argmax(logits[0, -1]))
        req.tokens_out = [tok]
        dt = self._prefill_time(m.cfg, req.prompt_len)
        if not needs_slot:
            req.finish_t = now + dt    # done at admission: no decode steps
            return dt
        slot = slots[0]
        new_layers = {}
        for key, arr in tenant.cache["layers"].items():
            arr = arr.clone()
            arr[:, slot] = pc["layers"][key][:, 0]
            new_layers[key] = arr
        pos = tenant.cache["pos"].clone()
        pos[slot] = pc["pos"][0]
        tenant.cache = {"pos": pos, "layers": new_layers}
        slot_tok = tenant.slot_tok.clone()
        slot_tok[slot, 0] = tok
        tenant.slot_tok = slot_tok
        tenant.slot_req[slot] = req
        tenant.slot_remaining[slot] = req.max_new_tokens - 1
        return dt

    # ------------------------------------------------------------------
    # one decode round (baseline modes only)
    # ------------------------------------------------------------------
    def _decode_round(self) -> float:
        live = [t for t in self.tenants.values() if t.active_slots()]
        dt = 0.0
        if self.mode == "batched":
            for t in live:
                dt += self._tenant_batched_step(t)
        else:  # time: every active request decodes alone, serialized
            for t in live:
                n_active = len(t.active_slots())
                logits, t.cache = t.model.decode_step(t.params, t.slot_tok,
                                                      t.cache)
                self._consume(t, logits)
                dt += n_active * self._ops_time(t.cfg, 1)
        return dt

    def _tenant_batched_step(self, t: Tenant) -> float:
        logits, t.cache = t.model.decode_step(t.params, t.slot_tok, t.cache)
        dt = self._ops_time(t.cfg, len(t.active_slots()))
        self._consume(t, logits)
        return dt

    def _consume(self, t: Tenant, logits: torch.Tensor) -> None:
        toks = torch.argmax(logits[:, -1], dim=-1)
        t.slot_tok = toks[:, None].to(torch.long)
        host = toks.tolist()
        for slot in t.active_slots():
            t.slot_req[slot].tokens_out.append(int(host[slot]))
            t.slot_remaining[slot] -= 1

    def _retire(self, t: Tenant, now: float) -> List[ServeRequest]:
        """Free slots of finished requests; returns the retired requests."""
        done: List[ServeRequest] = []
        for slot in t.active_slots():
            if t.slot_remaining[slot] <= 0:
                req = t.slot_req[slot]
                req.finish_t = now
                t.slot_req[slot] = None
                done.append(req)
        return done

    # ------------------------------------------------------------------
    # the event loop (vliw mode)
    # ------------------------------------------------------------------
    def _jit_capable(self, t: Tenant) -> bool:
        """Whether the tenant's decode steps compile to KernelPrograms:
        dense, MoE and SSM (the families ``Model`` ports)."""
        return t.cfg.arch_type in ("dense", "moe", "ssm")

    def _prefill_capable(self, t: Tenant) -> bool:
        # declared prefill covers dense tenants; MoE / SSM prompts take
        # Model.prefill and the analytic charge, as in the JAX package
        return self.declared_prefill and t.cfg.arch_type == "dense"

    def _declare_prefill(self, t: Tenant, req: ServeRequest, stream_id: int,
                         now: float) -> Optional[KernelProgram]:
        """Compile+bind ``req``'s prompt pass as a prefill KernelProgram.
        Returns None when the tenant has no free decode slot. The slot is
        RESERVED here; its token/cache state lands at the completion event
        (``_on_prefill_complete``). The program's deadline discounts the
        decode steps still to come."""
        needs_slot = req.max_new_tokens > 1
        slots = [i for i, r in enumerate(t.slot_req) if r is None]
        if needs_slot and not slots:
            return None
        s = req.prompt_len
        assert s <= t.cache_len, (s, t.cache_len)
        bucket = prefill_bucket(s)
        padded = F.pad(self._make_prompt(t, req), (0, bucket - s))
        template = self.jit.plan_cache.get_or_build(
            prefill_program_cache_key(t.model, t.params, bucket, t.cache,
                                      stacked=self.stacked_layers),
            lambda: build_dense_prefill_template(
                t.model, t.params, bucket, stacked=self.stacked_layers),
            guard=(t.model, t.params),
            group=("tenant-prefill", t.name, bucket))
        final = req.arrival_t + req.slo_s
        n_active = len(t.active_slots()) + (1 if needs_slot else 0)
        step_t = self._ops_time(t.cfg, max(n_active, 1))
        deadline = final - max(req.max_new_tokens - 1, 0) * step_t
        if deadline <= now:
            deadline = final
        slot = slots[0] if needs_slot else None
        prog = template.bind(
            stream_id=stream_id, tokens=padded, cache=t.cache,
            arrival_t=now, deadline_t=deadline,
            req_deadlines=((req.req_id, final),),
            kv_writes=(("kv", t.name, slot),) if slot is not None else (),
            env_extra={"real_len": s, "slot": slot, "req": req})
        if needs_slot:
            t.slot_req[slot] = req
            t.slot_remaining[slot] = req.max_new_tokens - 1
        return prog

    def _on_prefill_complete(self, t: Tenant, prog: KernelProgram,
                             now: float) -> Tuple[float, int]:
        """Land a completed prefill: first token, KV slot state, traffic
        charge. Returns (now, requests retired here)."""
        req: ServeRequest = prog.env["req"]
        tok = int(torch.argmax(prog.env["logits"][0]))
        req.tokens_out = [tok]
        now += self._prefill_attn_time(t.cfg, prog.env["real_len"])
        slot = prog.env["slot"]
        if slot is None:
            req.finish_t = now     # single token: done at prefill, no slot
            return now, 1
        t.cache = prog.env["cache"]
        slot_tok = t.slot_tok.clone()
        slot_tok[slot, 0] = tok
        t.slot_tok = slot_tok
        return now, 0

    def _build_program(self, t: Tenant, stream_id: int, now: float
                       ) -> KernelProgram:
        """Bind the tenant's next decode step from its cached template,
        carrying the tightest *this-step* deadline of its batch: each
        request's final deadline discounted by its decode steps still to
        come; already-missed requests are ignored while a healthy batchmate
        exists."""
        reqs = [(t.slot_req[s], t.slot_remaining[s])
                for s in t.active_slots()]
        step_t = self._ops_time(t.cfg, max(len(reqs), 1))
        finals = [r.arrival_t + r.slo_s for r, _ in reqs]
        step_deadlines = [f - max(rem - 1, 0) * step_t
                          for f, (_, rem) in zip(finals, reqs)]
        future = [d for d in step_deadlines if d > now]
        deadline = min(future) if future else \
            min(finals) if finals else math.inf
        batch = int(t.slot_tok.shape[0])
        key_fn, build = {
            "moe": (moe_program_cache_key, build_moe_decode_template),
            "ssm": (ssm_program_cache_key, build_ssm_decode_template),
        }.get(t.cfg.arch_type, (dense_program_cache_key,
                                build_dense_decode_template))
        stacked = self.stacked_layers
        template = self.jit.plan_cache.get_or_build(
            key_fn(t.model, t.params, batch, t.cache, stacked=stacked),
            lambda: build(t.model, t.params, batch, stacked=stacked),
            guard=(t.model, t.params), group=("tenant", t.name))
        return template.bind(
            stream_id=stream_id, tokens=t.slot_tok, cache=t.cache,
            arrival_t=now, deadline_t=deadline,
            kv_writes=tuple(("kv", t.name, s) for s in range(batch)),
            req_deadlines=tuple((r.req_id, f)
                                for (r, _), f in zip(reqs, finals)))

    def _run_event_loop(self, pending: List[ServeRequest]) -> float:
        self._arrival_pred.reset()
        session = self.jit.session()
        stream_ids = {name: i for i, name in enumerate(self.tenants)}
        id2name = {i: name for name, i in stream_ids.items()}
        inflight: Dict[str, KernelProgram] = {}
        waiting: List[ServeRequest] = []
        now, pi, n_done = 0.0, 0, 0
        while True:
            progressed = False
            # 1. live admission: dense tenants DECLARE the prompt pass as a
            #    prefill program; short prompts take the analytic charge. A
            #    tenant with a program inflight admits at its next step
            #    boundary; other tenants' requests are admitted past it.
            while pi < len(pending) and pending[pi].arrival_t <= now:
                req = pending[pi]
                pi += 1
                if self.predict_arrivals:
                    self._arrival_pred.observe(req.tenant, req.arrival_t)
                waiting.append(req)
            still: List[ServeRequest] = []
            for req in waiting:
                t = self.tenants[req.tenant]
                if req.tenant in inflight:
                    still.append(req)
                    continue
                if self._prefill_capable(t) \
                        and req.prompt_len >= self.prefill_declare_min:
                    prog = self._declare_prefill(
                        t, req, stream_ids[req.tenant], now)
                    if prog is None:
                        still.append(req)  # slots full; retry later
                        continue
                    inflight[req.tenant] = prog
                    session.admit(prog)
                    progressed = True
                    continue
                dt = self._admit(t, req, now)
                if dt == 0.0 and req.tokens_out is None:
                    still.append(req)      # tenant slots full; retry later
                    continue
                now += dt
                if not math.isnan(req.finish_t):
                    n_done += 1            # retired at admission
                progressed = True
            waiting = still
            if self.predict_arrivals:
                hint = self._arrival_pred.predict(now)
            else:
                hint = pending[pi].arrival_t if pi < len(pending) \
                    else math.inf
            session.set_next_arrival(hint)

            # 2. every tenant with live requests keeps a decode program in
            #    the pool — admitted between dispatches, not per round
            for name, t in self.tenants.items():
                if name not in inflight and t.active_slots():
                    prog = self._build_program(t, stream_ids[name], now)
                    if t.cfg.arch_type in ("moe", "ssm"):
                        session.stats.nondense_programs += 1
                    inflight[name] = prog
                    session.admit(prog)
                    progressed = True

            # 3. one scheduler decision on the virtual clock
            ev = session.tick(now)
            progressed |= ev.kind != "idle"
            now = max(now, ev.t)
            for prog in ev.completed:
                t = self.tenants[id2name[prog.stream_id]]
                del inflight[t.name]
                if prog.kind == "prefill":
                    now, done = self._on_prefill_complete(t, prog, now)
                    n_done += done
                    continue
                t.cache = prog.env["cache"]
                attn = self._attn_time(t.cfg, max(len(t.active_slots()), 1))
                self._consume(t, prog.env["logits"][:, None, :])
                now += attn
                n_done += len(self._retire(t, now))

            if n_done >= len(pending) and not session.live \
                    and pi >= len(pending) and not waiting:
                break
            if not progressed:
                if pi < len(pending) and now < pending[pi].arrival_t:
                    now = pending[pi].arrival_t   # idle: jump to arrival
                    continue
                # stall guard: nothing live, nothing decoding, nothing due
                # that could admit — the waiting requests stay unfinished
                if not session.live and not inflight and not any(
                        t.active_slots() for t in self.tenants.values()):
                    break
        self.jit_stats.merge(session.stats)
        return now

    # ------------------------------------------------------------------
    # round loop (baseline modes: rounds ARE their semantics)
    # ------------------------------------------------------------------
    def _run_rounds(self, pending: List[ServeRequest]) -> float:
        now, pi, n_done = 0.0, 0, 0
        while n_done < len(pending):
            progressed = False
            while pi < len(pending) and pending[pi].arrival_t <= now:
                req = pending[pi]
                t = self.tenants[req.tenant]
                dt = self._admit(t, req, now)
                if dt == 0.0 and req.tokens_out is None:
                    break  # tenant full; retry after this round
                now += dt
                if not math.isnan(req.finish_t):
                    n_done += 1        # retired at admission (single token)
                pi += 1
                progressed = True
            dt = self._decode_round()
            if dt == 0.0 and not progressed:
                if pi < len(pending):
                    now = max(now, pending[pi].arrival_t)
                    continue
                break
            now += dt
            for t in self.tenants.values():
                n_done += len(self._retire(t, now))
        return now

    # ------------------------------------------------------------------
    def run(self, trace: Sequence[ServeRequest], seed: int = 0
            ) -> ServeReport:
        """Serve ``trace`` (replayed in virtual time) and return the report.
        The caller's request objects are never mutated: results land on
        private copies in the report. ``seed`` keys prompt synthesis."""
        ids: Dict[int, int] = {}
        for r in trace:
            ids[r.req_id] = ids.get(r.req_id, 0) + 1
        dupes = sorted(i for i, n in ids.items() if n > 1)
        if dupes:
            raise ValueError(f"duplicate req_id(s) in trace: {dupes} — "
                             f"request ids must be unique per run")
        self._seed = int(seed)
        requests = [dataclasses.replace(
            r, finish_t=float("nan"), tokens_out=None, shed=False,
            degraded_from=None) for r in trace]
        pending = sorted(requests, key=lambda r: r.arrival_t)
        wall0 = _time.perf_counter()
        if self.mode == "vliw":
            makespan = self._run_event_loop(pending)
        else:
            makespan = self._run_rounds(pending)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = _time.perf_counter() - wall0
        return ServeReport(self.mode, requests, makespan, wall,
                           jit=self.jit_stats if self.mode == "vliw" else None)
