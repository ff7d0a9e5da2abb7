"""Multi-tenant serving engine: event-driven OoO serving with live admission.

The counterpart of the JAX package's ``serving/engine.py``. Three execution
modes, mirroring the paper's comparison end to end:

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

Arch support in vliw mode, as in the JAX package:

  ==========  ================================  ==========================
  arch_type   decode step                       prompt prefill
  ==========  ================================  ==========================
  dense       KernelProgram                     declared prefill program
                                                (>= prefill_declare_min;
                                                analytic below it)
  vlm         KernelProgram (the dense          analytic (patch prefix,
              template: its text path)          ``Model.prefill``)
  moe         KernelProgram (router glue +      analytic (``Model.prefill``)
              per-expert GEMMs)
  ssm         KernelProgram (scan recurrence    analytic (``Model.prefill``)
              glue)
  hybrid      monolithic batched step           analytic
  audio       monolithic batched step           analytic (encoder included)
  int8-KV     monolithic batched step           analytic
  (any arch)
  ==========  ================================  ==========================

``JitStats.nondense_programs`` counts the MoE / SSM decode programs
admitted. A "monolithic batched step" is ``Model.decode_step`` over the
tenant's slotted batch, interleaved into the same event loop on its home
device's clock after each scheduler decision. The baseline modes ("time",
"batched") run ``Model.decode_step`` for every family. A vlm prompt carries
its patch embeddings (zeros, ``num_patch_tokens`` of them, ahead of the
text) and an audio prompt its encoder frames (zeros, ``encoder_seq_len``):
the front ends are stubs, as in the JAX package.

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
emission, the bitwise oracle. Both give the same tokens. On the card
(``cuda_graphs=True``, the default, as the JAX package always compiles;
``core/graphs.py``) each stacked body, decode or prefill, replays as a
CUDA graph, so does each per-layer attention / MoE route / combine / SSM
core glue stage (the JAX package's ``_GLUE_JITS``), and so does every
monolithic ``Model.decode_step`` and ``Model.prefill`` call (whose layers
the JAX package runs under a compiled ``lax.scan``), keyed on the model's
config, dtype, ``kv_quant``, the params' identity and the inputs' shapes.
``cuda_graphs=False`` runs every one of them eagerly: the eager twin of the
graphed run. Graphs change no token.

The modelled mesh (``num_devices`` or an explicit ``DeviceSet``): each
tenant binds to a home device at its FIRST admission
(``distributed/placement.py``) and every op it declares runs on that
device's own virtual timeline — one ``JitSession`` per device, all sharing
one ``VLIWJit``'s plan and weight caches (keyed with the device id). Ops
never coalesce across devices. An MoE tenant whose expert count the mesh
size divides spans the mesh with its experts and pays a modelled
all-to-all on every expert trio. The devices are virtual timelines: their
kernels all run on the one card the engine serves on, so tokens are
identical at every mesh size.

``certify=True`` records one ``ScheduleTrace`` across the mesh and runs
the schedule certifier (``analysis/certify.py``) on every tick's
dispatches and, at the end, the request conservation check; a
``HazardViolation`` raises at the offending dispatch. The trace stays on
``last_trace``.

The front door: ``run`` replays a finite trace in virtual time;
``serve_forever(door)`` serves a ``FrontDoor`` (``serving/frontdoor.py``)
through the SAME per-device event-loop machinery until the door closes,
streaming each token through ``token_sink(req, tok, t)`` (the door's
per-request ``Ticket``) at its retire time ``t`` on the device timeline.
Emitting a token reads the argmax on the host, which is also where the
host waits for the card. With a ``MonotonicClock`` (the default) each
device timeline is floored at real elapsed time every iteration, so
arrival stamps, SLO deadlines and modelled charges share one axis; a
``VirtualClock`` follows the modelled timelines instead, and a door
preloaded with a scheduled trace replays exactly like ``run`` at every
mesh size (each device looks ahead only to the door's submissions that
can land on it; the JAX package's daemon looks ahead fleet-wide).

Admission control (``admission_control=True`` or an explicit
``AdmissionController``): when a request becomes due, the controller
admits it, degrades it down the SLO tier ladder, or sheds it, from the
modelled request cost (``_request_cost_s``) against the device's
committed backlog and the arrival forecast. Shed requests never take a
slot and count as SLO misses.

Live tuning (``live_tune=True``): the collaborative autotuner
(``core/autotuner.LiveTuner``) tunes each coalesced group's (bm, bn, bk)
for its co-resident shapes, once per group signature (``JitStats.
tune_cache``); the tuned ``bm`` reaches the launched ``coalesced_gemm``
and ``bn`` / ``bk`` stay modelled (``SuperkernelExecutor.execute``).
``tune_objective="greedy"`` tunes each group for its isolated latency
instead (the paper's Table 1 ablation). Tuning changes no token.
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
from repro_torch.analysis.certify import ScheduleCertifier, check_conservation
from repro_torch.configs.base import ModelConfig
from repro_torch.core import telemetry
from repro_torch.core.costmodel import CostModel, H100
from repro_torch.core.dispatch import DispatchStats
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
from repro_torch.core.plancache import PlanCacheStats
from repro_torch.core.schedtrace import ScheduleTrace
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.distributed.placement import DeviceSet, PlacementPolicy
from repro_torch.models.model import Model
from repro_torch.serving.admission import AdmissionController
from repro_torch.serving.frontdoor import FrontDoor, MonotonicClock
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
    # vliw runs only (None otherwise): index d = mesh slot d
    device_time_s: Optional[List[float]] = None   # final per-device clock
    device_busy_s: Optional[List[float]] = None   # modelled busy time

    @property
    def num_devices(self) -> int:
        return len(self.device_time_s) if self.device_time_s else 1

    @property
    def device_util(self) -> List[float]:
        """Per-device busy fraction of the fleet makespan."""
        if not self.device_busy_s or not self.modeled_time_s:
            return []
        return [b / self.modeled_time_s for b in self.device_busy_s]

    @property
    def device_skew(self) -> float:
        """max/mean per-device busy time; 1.0 = perfectly balanced."""
        if not self.device_busy_s:
            return 1.0
        mean = sum(self.device_busy_s) / len(self.device_busy_s)
        return max(self.device_busy_s) / mean if mean > 0 else 1.0

    @property
    def finished(self) -> List[ServeRequest]:
        return [r for r in self.requests if not np.isnan(r.finish_t)]

    @property
    def unfinished(self) -> int:
        """Requests that never finished (shed / stalled / unadmittable)."""
        return len(self.requests) - len(self.finished)

    @property
    def shed(self) -> int:
        """Requests the front door refused at admission (a subset of
        ``unfinished``; they count as SLO misses)."""
        return sum(1 for r in self.requests if r.shed)

    @property
    def slo_attainment(self) -> float:
        """Fraction of ALL requests that finished within their SLO
        (shed and unfinished requests count as misses)."""
        n = len(self.requests)
        return sum(r.met_slo for r in self.requests) / max(n, 1)

    def tier_attainment(self, original: bool = True) -> Dict[int, float]:
        """Per-tier SLO attainment (shed/unfinished count as misses).
        ``original=True`` groups a degraded request under the tier it
        arrived with; ``original=False`` under the tier it was served at."""
        def tier_of(r: ServeRequest) -> int:
            if original and r.degraded_from is not None:
                return r.degraded_from
            return r.tier
        out: Dict[int, List[ServeRequest]] = {}
        for r in self.requests:
            out.setdefault(tier_of(r), []).append(r)
        return {tier: sum(r.met_slo for r in grp) / len(grp)
                for tier, grp in sorted(out.items())}

    @property
    def goodput_rps(self) -> float:
        """SLO-met completions per modelled second."""
        met = sum(r.met_slo for r in self.requests)
        return met / self.modeled_time_s if self.modeled_time_s else 0.0

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

    def gap(self, tenant: str) -> float:
        """The tenant's current EWMA inter-arrival gap (inf if unseen)."""
        return self._gap.get(tenant, math.inf)

    def predict(self, now: float) -> float:
        est = math.inf
        for tenant, gap in self._gap.items():
            t_hat = self._last[tenant] + gap
            if t_hat <= now:
                t_hat = now + gap
            est = min(est, t_hat)
        return est


@dataclasses.dataclass
class _LoopState:
    """Mutable state of one event-loop epoch — a ``run`` replay or an open
    ``serve_forever`` door session — so both loops drive the identical
    per-device machinery; only the outer termination policy differs."""
    sessions: List[Any]
    trace: Optional[ScheduleTrace]
    cert: Optional[ScheduleCertifier]
    stream_ids: Dict[str, int]
    id2name: Dict[int, str]
    tenant_dev: Dict[str, int]
    queues: List[List[ServeRequest]]     # per-device admission queues
    pis: List[int]
    waiting: List[List[ServeRequest]]
    inflight: Dict[str, Any]
    now: List[float]                     # per-device virtual clocks
    busy: List[float]                    # analytic charges per device
    committed: List[float]               # admission-committed horizon
    certified: int = 0                   # dispatch records already certified
    n_done: int = 0                      # finished or shed
    n_shed: int = 0
    total: int = 0
    next_hint: Optional[Any] = None      # daemon: door's scheduled lookahead
    # per device: the waiting count last logged to the "waiting" gauge
    waiting_logged: List[int] = dataclasses.field(default_factory=list)


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
                 device: DeviceLike = None,
                 cuda_graphs: bool = True):
        assert mode in ("time", "batched", "vliw")
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
        # certify=True records a ScheduleTrace and certifies every tick's
        # dispatches (and the run's request conservation); the last run's
        # trace stays on ``last_trace``
        self.certify = certify
        self.last_trace: Optional[ScheduleTrace] = None
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
        # the front door's admit/degrade/shed policy, consulted once per
        # request when it becomes due (run and serve_forever alike); None
        # admits everything
        self.admission = admission if admission is not None else (
            AdmissionController() if admission_control else None)
        assert self.admission is None or mode == "vliw", \
            "admission control lives in the vliw event loop"
        # called as token_sink(req, token, t) for every token as it retires
        # on the device timeline; serve_forever wires the door's tickets
        self.token_sink = token_sink
        self.cost = cost or CostModel(H100)
        # the modelled mesh: N virtual device timelines, each with its own
        # scheduler and coalescer, sharing one VLIWJit's caches (keyed
        # with the device id); tenants bind at first admission
        if devices is not None:
            self.devices = devices
            if cost is not None and cost.device is devices.devices[0]:
                devices.bind_cost(0, cost)
            self.cost = devices.cost(0)
        else:
            self.devices = DeviceSet.homogeneous(self.cost.device,
                                                 max(1, int(num_devices)))
            # mesh slot 0 IS the engine's cost model: the template's
            # GEMM-suffix memo keys on cost identity
            self.devices.bind_cost(0, self.cost)
        assert len(self.devices) == 1 or mode == "vliw", \
            "multi-device serving requires mode='vliw' (baseline modes " \
            "define single-device round semantics)"
        self.placement = PlacementPolicy(self.devices)
        # per-device clocks and busy times of the last vliw run
        self._last_device_time: Optional[List[float]] = None
        self._last_device_busy: Optional[List[float]] = None
        # live tuning: see the module docstring
        self.jit = VLIWJit(self.cost, sched_cfg=sched_cfg,
                           max_group=max_group, plan_capacity=plan_capacity,
                           weight_budget_bytes=weight_budget_bytes,
                           live_tune=live_tune,
                           tune_objective=tune_objective,
                           cuda_graphs=cuda_graphs)
        self.jit_stats = JitStats()
        self._seed = 0
        for t in tenants:
            t.cache = t.model.init_cache(t.max_batch, t.cache_len)
            t.slot_req = [None] * t.max_batch
            t.slot_tok = torch.zeros((t.max_batch, 1), dtype=torch.long,
                                     device=self.device)
            t.slot_remaining = [0] * t.max_batch
        # occupied decode slots per tenant, kept at each take and free
        # (the "slots" gauge logs every change), and the seconds each
        # tenant has had none free (a waiting request's slot wait)
        self._occupied = {t.name: 0 for t in tenants}
        self._full = {t.name: telemetry.SlotClock() for t in tenants}
        self._slots_total = sum(t.max_batch for t in tenants)
        # the daemon's open epoch (live_jit_stats) and its last report,
        # kept also when the epoch ends by an exception
        self._open: Optional[_LoopState] = None
        self.last_report: Optional[ServeReport] = None

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

    def _request_cost_s(self, t: Tenant, req: ServeRequest) -> float:
        """Modelled end-to-end service cost of one request — the front
        door's admission currency: full prefill plus the remaining decode
        steps at the tenant's batch width, amortized over the batch."""
        m = max(t.max_batch, 1)
        per_tok = self._ops_time(t.cfg, m) / m
        return self._prefill_time(t.cfg, req.prompt_len) \
            + max(req.max_new_tokens - 1, 0) * per_tok

    def _emit_token(self, req: ServeRequest, tok: int, t: float) -> None:
        if self.token_sink is not None:
            self.token_sink(req, tok, t)

    def _take_slot(self, t: Tenant, slot: int, req: ServeRequest) -> None:
        t.slot_req[slot] = req
        self._slots_changed(t, self._occupied[t.name] + 1)

    def _free_slot(self, t: Tenant, slot: int) -> None:
        t.slot_req[slot] = None
        self._slots_changed(t, self._occupied[t.name] - 1)

    def _slots_changed(self, t: Tenant, n: int) -> None:
        self._occupied[t.name] = n
        now = telemetry.now()
        self._full[t.name].set(n >= t.max_batch, now)
        telemetry.gauge("slots", t.name, n, t.max_batch, now)

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
        pbatch = {"tokens": self._make_prompt(tenant, req)}
        # the stubbed front ends: zero patch embeddings / encoder frames
        if m.cfg.arch_type == "vlm":
            pbatch["patch_embeds"] = torch.zeros(
                (1, m.cfg.num_patch_tokens, m.cfg.d_model), dtype=m.dtype,
                device=self.device)
        if m.cfg.is_encdec:
            pbatch["frames"] = torch.zeros(
                (1, m.cfg.encoder_seq_len, m.cfg.d_model), dtype=m.dtype,
                device=self.device)
        logits, pc = self._prefill(tenant, pbatch)
        tok = int(torch.argmax(logits[0, -1]))
        req.tokens_out = [tok]
        dt = self._prefill_time(m.cfg, req.prompt_len)
        self._emit_token(req, tok, now + dt)
        if not needs_slot:
            req.finish_t = now + dt    # done at admission: no decode steps
            return dt
        slot = slots[0]
        # every cache leaf: k / v and their int8 scales, an SSM's conv /
        # h, whisper's cross k / v
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
        self._take_slot(tenant, slot, req)
        tenant.slot_remaining[slot] = req.max_new_tokens - 1
        return dt

    # ------------------------------------------------------------------
    # one decode round (baseline modes only)
    # ------------------------------------------------------------------
    def _decode_round(self, now: float = 0.0) -> float:
        live = [t for t in self.tenants.values() if t.active_slots()]
        dt = 0.0
        if self.mode == "batched":
            for t in live:
                dt += self._tenant_batched_step(t, now + dt)
        else:  # time: every active request decodes alone, serialized
            for t in live:
                n_active = len(t.active_slots())
                logits, t.cache = self._decode_step(t)
                self._consume(t, logits, now + dt)
                dt += n_active * self._ops_time(t.cfg, 1)
        return dt

    def _tenant_batched_step(self, t: Tenant, now: float = 0.0) -> float:
        logits, t.cache = self._decode_step(t)
        dt = self._ops_time(t.cfg, len(t.active_slots()))
        self._consume(t, logits, now + dt)
        return dt

    # ------------------------------------------------------------------
    # the monolithic model calls
    # ------------------------------------------------------------------
    def _model_head(self, t: Tenant, method: str) -> Tuple:
        """A monolithic call's graph key (beyond the params' identity and
        the inputs' shapes): the method, the model's config, param dtype
        and ``kv_quant``."""
        m = t.model
        return (method, m.cfg, str(m.dtype).removeprefix("torch."),
                m.kv_quant)

    def _decode_step(self, t: Tenant):
        """``Model.decode_step`` on the tenant's slotted batch: (logits,
        new cache); on the card a replay of its CUDA graph. Its device
        time goes on the enclosing span while tracing."""
        m = t.model
        with telemetry.body("decode", t.slot_tok):
            if not self.jit.cuda_graphs:
                return m.decode_step(t.params, t.slot_tok, t.cache)
            out = self.jit.graphs.monolithic(
                self._model_head(t, "decode_step"),
                lambda p, a: dict(zip(("logits", "cache"), m.decode_step(
                    p, a["tokens"], a["cache"]))),
                t.params, {"tokens": t.slot_tok, "cache": t.cache},
                self.jit.executor.stats)
        return out["logits"], out["cache"]

    def _prefill(self, t: Tenant, pbatch: Dict[str, torch.Tensor]):
        """``Model.prefill`` of one prompt at the tenant's cache length:
        (logits, cache); on the card a replay of its CUDA graph (the
        prompt's length is in the key, through its shape). Its device
        time goes on the enclosing span while tracing."""
        m, cl = t.model, t.cache_len
        with telemetry.body("prefill", pbatch["tokens"]):
            if not self.jit.cuda_graphs:
                return m.prefill(t.params, pbatch, cache_len=cl)
            out = self.jit.graphs.monolithic(
                self._model_head(t, "prefill") + (cl,),
                lambda p, a: dict(zip(("logits", "cache"),
                                      m.prefill(p, a, cache_len=cl))),
                t.params, pbatch, self.jit.executor.stats)
        return out["logits"], out["cache"]

    def _consume(self, t: Tenant, logits: torch.Tensor,
                 now: float = 0.0) -> None:
        """Append each active slot's greedy token and stream it out at
        ``now``. Reading the tokens on the host waits for the card, so
        the device times of the bodies before it resolve here."""
        with telemetry.span("engine.readback"):
            toks = torch.argmax(logits[:, -1], dim=-1)
            t.slot_tok = toks[:, None].to(torch.long)
            host = toks.tolist()
            telemetry.resolve()
            for slot in t.active_slots():
                req = t.slot_req[slot]
                req.tokens_out.append(int(host[slot]))
                self._emit_token(req, int(host[slot]), now)
                t.slot_remaining[slot] -= 1

    def _retire(self, t: Tenant, now: float) -> List[ServeRequest]:
        """Free slots of finished requests; returns the retired requests."""
        done: List[ServeRequest] = []
        with telemetry.span("engine.retire"):
            for slot in t.active_slots():
                if t.slot_remaining[slot] <= 0:
                    req = t.slot_req[slot]
                    req.finish_t = now
                    self._free_slot(t, slot)
                    done.append(req)
        return done

    # ------------------------------------------------------------------
    # the event loop (vliw mode)
    # ------------------------------------------------------------------
    def _jit_capable(self, t: Tenant) -> bool:
        """Whether the tenant's decode steps compile to KernelPrograms:
        dense / vlm GQA, MoE and SSM over a bf16 / fp32 cache. Hybrid,
        audio and int8-KV tenants take the monolithic batched step (the
        arch table in the module docstring)."""
        return t.cfg.arch_type in ("dense", "vlm", "moe", "ssm") \
            and not t.model.kv_quant

    def _prefill_capable(self, t: Tenant) -> bool:
        # declared prefill covers pure-dense tenants; vlm / MoE / SSM
        # prompts take Model.prefill and the analytic charge, as in the
        # JAX package
        return self.declared_prefill and t.cfg.arch_type == "dense" \
            and self._jit_capable(t)

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
            self._take_slot(t, slot, req)
            t.slot_remaining[slot] = req.max_new_tokens - 1
        return prog

    def _on_prefill_complete(self, t: Tenant, prog: KernelProgram,
                             now: float) -> Tuple[float, int]:
        """Land a completed prefill: first token, KV slot state, traffic
        charge. Returns (now, requests retired here)."""
        req: ServeRequest = prog.env["req"]
        with telemetry.span("engine.land"):
            tok = int(torch.argmax(prog.env["logits"][0]))
            telemetry.resolve()
            req.tokens_out = [tok]
            now += self._prefill_attn_time(t.cfg, prog.env["real_len"])
            self._emit_token(req, tok, now)
            slot = prog.env["slot"]
            if slot is None:
                req.finish_t = now  # single token: done at prefill, no slot
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
        dense = (dense_program_cache_key, build_dense_decode_template)
        key_fn, build = {
            "dense": dense, "vlm": dense,
            "moe": (moe_program_cache_key, build_moe_decode_template),
            "ssm": (ssm_program_cache_key, build_ssm_decode_template),
        }[t.cfg.arch_type]
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

    def _open_loop(self, *, next_hint: Optional[Any] = None) -> _LoopState:
        """A fresh event-loop epoch: one JitSession per mesh device, all
        sharing this engine's VLIWJit and (when certifying) ONE trace, so
        the certifier sees the whole mesh. Device 0 reuses the jit's own
        coalescer (the single-device setup)."""
        # arrival history of a previous epoch describes another workload
        self._arrival_pred.reset()
        # the gauges' values as the epoch opens (a change log needs them)
        for t in self.tenants.values():
            telemetry.gauge("slots", t.name, self._occupied[t.name],
                            t.max_batch)
        for d in range(len(self.devices)):
            telemetry.gauge("waiting", d, 0)
        n_dev = len(self.devices)
        trace = ScheduleTrace() if self.certify else None
        sessions = [self.jit.session(
            device=d, cost=None if d == 0 else self.devices.cost(d),
            trace=trace) for d in range(n_dev)]
        stream_ids = {name: i for i, name in enumerate(self.tenants)}
        return _LoopState(
            sessions=sessions, trace=trace,
            cert=ScheduleCertifier() if trace is not None else None,
            stream_ids=stream_ids,
            id2name={i: name for name, i in stream_ids.items()},
            tenant_dev={n: p.device
                        for n, p in self.placement.assignments.items()},
            queues=[[] for _ in range(n_dev)], pis=[0] * n_dev,
            waiting=[[] for _ in range(n_dev)], inflight={},
            now=[0.0] * n_dev, busy=[0.0] * n_dev,
            committed=[0.0] * n_dev, next_hint=next_hint,
            waiting_logged=[0] * n_dev)

    def _dev_of(self, st: _LoopState, name: str) -> int:
        """The tenant's home device, bound at its first admission. A MoE
        tenant whose experts span the mesh registers its span with its
        home session, which prices the all-to-all from then on."""
        d = st.tenant_dev.get(name)
        if d is None:
            t = self.tenants[name]
            pl = self.placement.place(name, t.cfg, batch=t.max_batch)
            d = st.tenant_dev[name] = pl.device
            if pl.expert_span > 1:
                st.sessions[d].set_stream_span(st.stream_ids[name],
                                               pl.expert_span)
        return d

    def _route(self, st: _LoopState, req: ServeRequest) -> int:
        """Append ``req`` to its home device's admission queue."""
        d = self._dev_of(st, req.tenant)
        st.queues[d].append(req)
        st.total += 1
        telemetry.polled(req.req_id, req.tenant)
        return d

    def _door_decision(self, st: _LoopState, req: ServeRequest, d: int
                       ) -> bool:
        """Consult the admission controller once, when ``req`` first
        becomes due on its device's clock. False: shed at the door (it
        never takes a slot and stays out of the trace, but counts as an
        SLO miss)."""
        t = self.tenants[req.tenant]
        cost_s = self._request_cost_s(t, req)
        backlog = max(0.0, st.committed[d] - st.now[d])
        dec = self.admission.decide(req, st.now[d], backlog, cost_s,
                                    self._arrival_pred.gap(req.tenant))
        if dec.action == "shed":
            req.shed = True
            st.n_done += 1
            st.n_shed += 1
            return False
        if dec.action == "degrade":
            req.degraded_from = req.tier
            req.tier = dec.tier
            req.slo_s = dec.slo_s
        # commit the modelled cost to the device's completion horizon
        st.committed[d] = max(st.committed[d], st.now[d]) + cost_s
        return True

    def _note_retires(self, st: _LoopState, reqs, d: int) -> None:
        t, lives = telemetry.now(), telemetry.RECORDER.requests
        for r in reqs:
            life = lives.get(r.req_id)
            if life is not None:
                life.retired = t
        if st.trace is not None:
            st.trace.req_retires.extend((r.req_id, st.now[d]) for r in reqs)
            for r in reqs:
                st.trace.retire_devices[r.req_id] = d

    def _device_pass(self, st: _LoopState, d: int) -> bool:
        """One pass over device ``d``'s timeline: drain due arrivals
        (through the admission controller when there is one), admit
        waiting requests, keep every tenant homed here with live requests
        in the pool, take one scheduler decision and land completions.
        Returns True if anything progressed. Each phase is a top-level
        span while tracing (``core/telemetry.py``)."""
        progressed = False
        session, q = st.sessions[d], st.queues[d]
        trace, cert, now, busy = st.trace, st.cert, st.now, st.busy
        # 1. live admission (_admit_waiting)
        if st.waiting[d] or (st.pis[d] < len(q)
                             and q[st.pis[d]].arrival_t <= now[d]):
            progressed = self._admit_waiting(st, d)
        if self.predict_arrivals:
            hint = self._arrival_pred.predict(now[d])
        else:
            # replay: oracle lookahead into the routed trace; the daemon
            # also consults the door's scheduled submissions that can land
            # on this device (its tenants', and those not placed yet)
            hint = q[st.pis[d]].arrival_t if st.pis[d] < len(q) \
                else math.inf
            if st.next_hint is not None:
                nxt = st.next_hint(
                    now[d], lambda r: st.tenant_dev.get(r.tenant, d) == d)
                if nxt is not None:
                    hint = min(hint, nxt)
        session.set_next_arrival(hint)

        # 2. every JIT-capable tenant homed here with live requests keeps
        #    a decode program in this device's pool — admitted between
        #    dispatches
        due = [(name, t) for name, t in self.tenants.items()
               if st.tenant_dev.get(name) == d and self._jit_capable(t)
               and name not in st.inflight and t.active_slots()]
        if due:
            with telemetry.span("engine.bind"):
                for name, t in due:
                    prog = self._build_program(t, st.stream_ids[name],
                                               now[d])
                    if t.cfg.arch_type in ("moe", "ssm"):
                        session.stats.nondense_programs += 1
                    st.inflight[name] = prog
                    session.admit(prog)
            progressed = True

        # 3. one scheduler decision on device d's virtual clock
        ev = session.tick(now[d])
        if cert is not None:
            # certify this tick's dispatches where they happened: a
            # HazardViolation raises here with the offending group last
            # on the (mesh-wide) trace
            for dr in trace.dispatches[st.certified:]:
                cert.observe(dr)
            st.certified = len(trace.dispatches)
        progressed |= ev.kind != "idle"
        now[d] = max(now[d], ev.t)
        for prog in ev.completed:
            name = st.id2name[prog.stream_id]
            t = self.tenants[name]
            del st.inflight[name]
            if prog.kind == "prefill":
                t0 = now[d]
                now[d], done = self._on_prefill_complete(t, prog, now[d])
                busy[d] += now[d] - t0
                st.n_done += done
                if done:
                    self._note_retires(st, [prog.env["req"]], d)
                continue
            t.cache = prog.env["cache"]
            attn = self._attn_time(t.cfg, max(len(t.active_slots()), 1))
            self._consume(t, prog.env["logits"][:, None, :], now[d] + attn)
            now[d] += attn
            busy[d] += attn
            retired = self._retire(t, now[d])
            st.n_done += len(retired)
            self._note_retires(st, retired, d)

        # 4. the other tenants homed here interleave monolithic batched
        #    steps on this device's clock
        for name, t in self.tenants.items():
            if st.tenant_dev.get(name) != d:
                continue
            if not self._jit_capable(t) and t.active_slots():
                with telemetry.span("engine.step"):
                    dt = self._tenant_batched_step(t, now[d])
                now[d] += dt
                busy[d] += dt
                retired = self._retire(t, now[d])
                st.n_done += len(retired)
                self._note_retires(st, retired, d)
                progressed = True
        return progressed

    def _admit_waiting(self, st: _LoopState, d: int) -> bool:
        """Step 1 of a device pass, live admission on device d's timeline:
        dense tenants DECLARE the prompt pass as a prefill program; short
        prompts and MoE / SSM tenants take the analytic charge. A tenant
        with a program inflight admits at its next step boundary; other
        tenants' due requests are admitted past it. Stamps each request's
        lifecycle with its admission and its slot wait. Returns True if
        anything progressed."""
        progressed = False
        session, q, wq = st.sessions[d], st.queues[d], st.waiting[d]
        trace, now, busy = st.trace, st.now, st.busy
        with telemetry.span("engine.admit"):
            t_in = telemetry.now()
            while st.pis[d] < len(q) and q[st.pis[d]].arrival_t <= now[d]:
                req = q[st.pis[d]]
                st.pis[d] += 1
                if self.predict_arrivals or self.admission is not None:
                    self._arrival_pred.observe(req.tenant, req.arrival_t)
                if self.admission is not None \
                        and not self._door_decision(st, req, d):
                    progressed = True   # shed at the door: resolved here
                    continue
                wq.append(req)
                self._begins_wait(req, t_in)
            still: List[ServeRequest] = []
            for req in wq:
                t = self.tenants[req.tenant]
                if req.tenant in st.inflight:
                    still.append(req)
                    continue
                if self._prefill_capable(t) \
                        and req.prompt_len >= self.prefill_declare_min:
                    full_s = self._full[req.tenant].reading(telemetry.now())
                    prog = self._declare_prefill(
                        t, req, st.stream_ids[req.tenant], now[d])
                    if prog is None:
                        still.append(req)  # slots full; retry later
                        continue
                    self._admitted(req, telemetry.now(), full_s)
                    st.inflight[req.tenant] = prog
                    session.admit(prog)
                    if trace is not None:
                        trace.req_admits.append((req.req_id, now[d]))
                        trace.req_devices[req.req_id] = d
                    progressed = True
                    continue
                t_admit = telemetry.now()
                full_s = self._full[req.tenant].reading(t_admit)
                dt = self._admit(t, req, now[d])
                if dt == 0.0 and req.tokens_out is None:
                    still.append(req)      # tenant slots full; retry later
                    continue
                self._admitted(req, t_admit, full_s)
                now[d] += dt
                busy[d] += dt
                if trace is not None:
                    trace.req_admits.append((req.req_id, now[d]))
                    trace.req_devices[req.req_id] = d
                if not math.isnan(req.finish_t):
                    st.n_done += 1         # retired at admission
                    self._note_retires(st, [req], d)
                progressed = True
            st.waiting[d] = still
            self._note_waiting(st, d)
        return progressed

    def _begins_wait(self, req: ServeRequest, t: float) -> None:
        """``req`` joins its device's waiting list at host time ``t``."""
        life = telemetry.RECORDER.requests.get(req.req_id)
        if life is not None:
            life.mark = self._full[req.tenant].reading(t)

    def _admitted(self, req: ServeRequest, t: float, full_s: float
                  ) -> None:
        """``req`` left the waiting list at host time ``t`` (a declared
        prefill program, or the monolithic ``_admit``): its lifecycle's
        admission stamp and the seconds of its wait its tenant had no free
        slot, from ``full_s``, its tenant's slot clock read before the
        request took a slot."""
        life = telemetry.RECORDER.requests.get(req.req_id)
        if life is not None:
            life.admitted = t
            life.wait_slots = full_s - life.mark

    def _note_waiting(self, st: _LoopState, d: int) -> None:
        """After device d's admission the "waiting" gauge logs a change
        of its waiting requests."""
        n = len(st.waiting[d])
        if n != st.waiting_logged[d]:
            st.waiting_logged[d] = n
            telemetry.gauge("waiting", d, n)

    def _close_loop(self, st: _LoopState,
                    requests: Sequence[ServeRequest]) -> None:
        trace, cert, sessions = st.trace, st.cert, st.sessions
        if trace is not None:
            # close the request lifecycle, then balance it: SLO-demoted
            # requests from every device's scheduler, plus admitted
            # requests that never finished (shed requests were never
            # admitted and stay out of the trace)
            trace.evicted = set()
            for s in sessions:
                trace.evicted |= set(s.sched.demoted_requests())
            by_id = {r.req_id: r for r in requests}
            admitted = {rid for rid, _ in trace.req_admits}
            trace.unfinished = {rid for rid in admitted
                                if math.isnan(by_id[rid].finish_t)}
            cert.checks += 1
            cert.violations.extend(check_conservation(trace))
            sessions[0].stats.hazard_checks += cert.checks
            sessions[0].stats.hazard_violations += len(cert.violations)
        self.last_trace = trace
        # dispatch time lives in each session's stats; the analytic
        # charges (prefill, attention) were accumulated in st.busy
        self._last_device_time = list(st.now)
        self._last_device_busy = [
            st.busy[d] + sessions[d].stats.modeled_time_s
            for d in range(len(sessions))]
        telemetry.resolve()
        self.jit_stats.merge(self._loop_stats(st))

    @staticmethod
    def _loop_stats(st: _LoopState) -> JitStats:
        """The epoch's counters so far, summed over its sessions. The
        shared caches' delta covers the whole loop (its last monolithic
        steps ran after the last tick). The mesh's sessions share one
        executor and one pair of plan caches, so each session's delta of
        them holds the others' work too: it is taken once, from device 0's
        session (opened first), brought up to date here."""
        st.sessions[0]._sync_cache_stats()
        out = JitStats().merge(st.sessions[0].stats)
        for s in st.sessions[1:]:
            out.merge(dataclasses.replace(
                s.stats, plan_cache=PlanCacheStats(),
                block_plans=PlanCacheStats(), tune_cache=PlanCacheStats(),
                dispatch=DispatchStats()))
        return out

    def live_jit_stats(self) -> JitStats:
        """The engine's folded ``JitStats`` with the open daemon epoch's
        sessions added, in the middle of the epoch (a copy; what the
        epoch's close will fold, before the certifier's close-out)."""
        out = JitStats().merge(self.jit_stats)
        if self._open is not None:
            out.merge(self._loop_stats(self._open))
        return out

    def _all_idle(self, st: _LoopState) -> bool:
        """Nothing live, inflight or decoding on any device."""
        return not any(s.live for s in st.sessions) and not st.inflight \
            and not any(t.active_slots() for t in self.tenants.values())

    def _idle_jump(self, st: _LoopState) -> bool:
        """Idle devices jump to their next routed arrival; True if any
        clock moved."""
        advanced = False
        for d in range(len(st.queues)):
            if st.pis[d] < len(st.queues[d]) \
                    and st.now[d] < st.queues[d][st.pis[d]].arrival_t:
                st.now[d] = st.queues[d][st.pis[d]].arrival_t
                advanced = True
        return advanced

    def _run_event_loop(self, pending: List[ServeRequest]) -> float:
        st = self._open_loop()
        # route the arrival-sorted trace onto per-device admission queues;
        # placement binds in arrival order of each tenant's first request
        for req in pending:
            self._route(st, req)
        n_dev = len(self.devices)
        while True:
            telemetry.refresh()
            progressed = False
            for d in range(n_dev):
                progressed |= self._device_pass(st, d)
            if st.n_done >= st.total \
                    and not any(s.live for s in st.sessions) \
                    and all(st.pis[d] >= len(st.queues[d])
                            for d in range(n_dev)) \
                    and not any(st.waiting):
                break
            if not progressed:
                if self._idle_jump(st):
                    continue
                if not any(st.waiting):
                    break
                # stall guard: every queue is exhausted, every waiting
                # request was refused admission, and nothing inflight or
                # decoding could change that — the requests stay
                # unfinished and surface in ServeReport.unfinished
                if self._all_idle(st):
                    break
        self._close_loop(st, pending)
        return max(st.now)

    # ------------------------------------------------------------------
    # the front door (daemon mode)
    # ------------------------------------------------------------------
    def _live_stats(self, st: _LoopState, served: List[ServeRequest],
                    t: float) -> Dict[str, Any]:
        """The heartbeat's dict, from running counts kept at the events
        (no scan of the epoch's requests): requests submitted, finished,
        shed, tenants with a program in flight, waiting requests, occupied
        of all decode slots, the epoch's mean group so far."""
        groups = st.sessions[0].stats.groups
        for s in st.sessions[1:]:
            groups = groups + s.stats.groups
        return {
            "t": t,
            "submitted": len(served),
            "finished": st.n_done - st.n_shed,
            "shed": st.n_shed,
            "inflight": len(st.inflight),
            "waiting": sum(len(w) for w in st.waiting),
            "occupied": sum(self._occupied.values()),
            "slots": self._slots_total,
            "mean_group": groups.mean,
            "device_time_s": list(st.now),
        }

    def serve_forever(self, door: FrontDoor, *,
                      clock: Optional[Any] = None,
                      seed: int = 0,
                      idle_poll_s: float = 0.005,
                      on_stats: Optional[Any] = None,
                      stats_interval_s: float = 1.0) -> ServeReport:
        """Serve continuously from ``door`` until it closes (daemon mode).

        The same per-device event-loop machinery as ``run``, driven by a
        clock instead of a finite trace: requests stream in through the
        thread-safe ``FrontDoor`` (arrival-stamped on the clock), the
        admission controller (when configured) admits / degrades / sheds
        each one as it becomes due, tokens stream out per request as they
        retire (``FrontDoor.deliver`` -> the request's ``Ticket``), and
        the engine IDLES while the door is open and empty. Closing the
        door flushes all in-flight work; the loop then returns the
        epoch's ``ServeReport`` (shed requests included, as SLO misses).

        ``clock`` is a ``MonotonicClock`` by default: each device timeline
        is floored at real elapsed time every iteration. A follower
        ``VirtualClock`` tracks the modelled timelines instead, so a door
        preloaded with scheduled submissions replays exactly like ``run``.
        ``seed`` keys prompt synthesis, as in ``run``. ``on_stats`` is
        called at most every ``stats_interval_s`` clock seconds with a
        live-stats dict (``_live_stats``) — the daemon's heartbeat.
        ``door.stop()`` leaves the loop at its next pass without draining.
        However the loop ends — the door drained, stopped, or an exception
        from ``on_stats`` or the loop — the epoch closes: unfinished
        requests give back their slots, its ``JitStats`` fold into
        ``jit_stats`` and its report, unfinished requests counted, stays
        on ``last_report`` (the exception then propagates). All torch
        work runs on the calling thread; each phase of a pass is a
        top-level span while tracing (``core/telemetry.py``)."""
        assert self.mode == "vliw", \
            "daemon serving is a vliw-engine feature (baseline modes " \
            "define closed-trace round semantics)"
        self._seed = int(seed)
        clock = clock if clock is not None else MonotonicClock()
        wall0 = _time.perf_counter()
        st = self._open = self._open_loop(next_hint=door.next_arrival)
        served: List[ServeRequest] = []
        seen_ids: Dict[int, int] = {}
        n_dev = len(self.devices)
        prev_sink = self.token_sink
        if prev_sink is None:
            self.token_sink = door.deliver
        last_stats = clock.now()
        span = telemetry.span
        telemetry.refresh(start=True)
        try:
            while not door.stopped:
                telemetry.refresh()
                with span("engine.poll"):
                    now_r = clock.now()
                    if clock.authoritative:
                        # real clock: a device cannot serve in the past
                        for d in range(n_dev):
                            st.now[d] = max(st.now[d], now_r)
                    for req in door.poll(now_r):
                        if req.req_id in seen_ids:
                            raise ValueError(
                                f"duplicate req_id {req.req_id} through "
                                f"the door — request ids key prompt "
                                f"synthesis and retirement accounting")
                        seen_ids[req.req_id] = 1
                        served.append(req)
                        self._route(st, req)
                progressed = False
                for d in range(n_dev):
                    progressed |= self._device_pass(st, d)
                # a follower clock tracks the modelled timelines; the real
                # clock ignores this
                clock.advance_to(max(st.now))
                if on_stats is not None \
                        and clock.now() - last_stats >= stats_interval_s:
                    last_stats = clock.now()
                    with span("engine.heartbeat"):
                        on_stats(self._live_stats(st, served, last_stats))
                if progressed or self._idle_jump(st):
                    continue
                if self._all_idle(st):
                    # closed and drained: the flush is complete. Open:
                    # idle-wait for a submission or the closing
                    if door.finished(now_r) \
                            and all(st.pis[d] >= len(st.queues[d])
                                    for d in range(n_dev)):
                        break
                    targets = []
                    nxt = door.next_arrival(now_r)
                    if nxt is not None:
                        targets.append(max(nxt, now_r))
                    if door.close_at is not None \
                            and door.close_at > now_r:
                        targets.append(door.close_at)
                    with span("engine.idle"):
                        clock.sleep_until(min(targets) if targets
                                          else now_r + idle_poll_s)
        finally:
            self.token_sink = prev_sink
            self._open = None
            # requests left unfinished (a stop, an exception) give their
            # slots back, so a later epoch starts with every slot free;
            # their programs in flight go with this epoch's sessions
            for t in self.tenants.values():
                for slot in t.active_slots():
                    t.slot_remaining[slot] = 0
                    self._free_slot(t, slot)
            self._close_loop(st, served)
            self.last_report = ServeReport(
                "vliw", served, max(st.now) if st.now else 0.0,
                _time.perf_counter() - wall0, jit=self.jit_stats,
                device_time_s=self._last_device_time,
                device_busy_s=self._last_device_busy)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_report.wall_time_s = _time.perf_counter() - wall0
        return self.last_report

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
            dt = self._decode_round(now)
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
            dev_t, dev_b = self._last_device_time, self._last_device_busy
        else:
            makespan = self._run_rounds(pending)
            dev_t = dev_b = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = _time.perf_counter() - wall0
        return ServeReport(self.mode, requests, makespan, wall,
                           jit=self.jit_stats if self.mode == "vliw" else None,
                           device_time_s=dev_t, device_busy_s=dev_b)
