"""The OoO VLIW JIT runtime — real, event-driven execution path.

The counterpart of the JAX package's ``core/jit.py``, per-layer regime.
Multiple tenant streams, each an *instruction stream* of declared kernel
ops, are multiplexed onto one device by (a) clustering and coalescing
compatible GEMMs into superkernels (the hand-written ``coalesced_gemm``
kernel, through ``core/dispatch.py``) and (b) OoO, SLO-aware interleaving
of the streams.

Execution model: a tenant's decode step is compiled into a
``KernelProgram`` — an alternating sequence of GEMM stages (declared to the
JIT, coalescible across tenants) and glue stages (norms, rope, cache
updates, softmax — plain PyTorch, per tenant). Prompt prefills compile the
same way (``build_dense_prefill_template``): the prompt length is the GEMM
m dimension, padded to a power-of-two bucket (``prefill_bucket``), and the
program epilogue writes the request's KV rows into the tenant's slotted
cache — so prompts enter the live op pool and coalesce with decode traffic.

The runtime is a virtual-time event loop. A ``JitSession`` keeps the
scheduler, the live op pool and the stats open across calls, so programs
are admitted mid-flight between superkernel dispatches, the next known
admission feeds the scheduler's stagger/WAIT branch, and per-request SLOs
flow into per-op ``latest_start_t``. ``VLIWJit.run`` is the closed-world
wrapper. Program templates and block plans live in persistent plan caches
owned by the ``VLIWJit``; packed weights live in the executor's cache.

A session drives ONE device of the modelled mesh (``device``, its own
``cost``): its scheduler and coalescer own that device's op pool, and the
shared block-plan memo and packed-weight cache key every entry with the
device id. ``record_trace=True`` (or a ``trace`` shared by the sessions of
a mesh) records a ``ScheduleTrace`` for the schedule certifier
(``analysis/certify.py``): program admissions, waits and one
``DispatchRecord`` per superkernel, appended before it executes. A stream
whose MoE experts span several devices (``set_stream_span``) pays the
modelled all-to-all on every expert trio it dispatches.

KV-cache updates are functional: every epilogue returns NEW cache tensors
and leaves the bound ones as they were. The serving engine binds
``tenant.cache`` into programs and relies on that.

Layer-stacked templates are the default (``stacked=True`` on the template
functions and cache keys, ``stacked_layers=True`` on the engine), as in the
JAX package. A template holds ONE ``StackedGemmStage`` per homogeneous
sub-stack of layers (``partition_layers`` over the local/global attention
flags) instead of ~6 stages a layer: the whole sub-stack is one schedulable
op whose operands are the params tree's stacked ``[L, k, n]`` blocks, padded
once into the executor's persistent cache (``stacked_operand``). Where the
JAX package runs a jitted ``lax.scan`` over the layer axis, the body here is
a Python loop over the sub-stack's layers; on the card a body, decode or
prefill, is captured once per key into a CUDA graph and replayed
(``VLIWJit.graphs``, core/graphs.py, the counterpart of the JAX package's
per-body jits; the CPU runs it eagerly). Each of its GEMMs is one solo
``coalesced_gemm`` launch (``_scan_gemm``, G = 1) that replicates the
executor's dispatch of a lone op exactly: the same m-tile bucket, the same
padded envelope, the same glue functions. So a stacked program is bitwise
equal to the per-layer one. A stacked op is charged as ``layers``
sequential tile-waves per operand (``GemmShape.layers``) and coalesces
only with ops of the same stack signature (``clustering.coalesce_key``);
a coalesced group of bodies runs back to back. ``stacked=False`` keeps
the per-layer emission as the bitwise oracle; its attention, MoE route /
combine and SSM core glue are ``GlueIO`` stages, each replayed on the card
as the graph of its ``_GLUE_JITS`` key (the JAX package's jitted per-layer
glue), the other glue eager.

MoE and SSM tenants compile the same way (``build_moe_decode_template``,
``build_ssm_decode_template``). An MoE layer keeps the dense attention
scaffolding and replaces the gated FFN by router / dispatch glue, 3·E
per-expert GEMMs (tagged ``expert_*``, the expert index in the weight key,
so the same expert's GEMMs coalesce across tenants: ``JitStats.
expert_coalesced``) and a combine glue. An SSM layer is its in projection,
the selective-scan recurrence as glue (``models/ssm.decode_core``) and its
out projection. In the stacked regime an MoE body adds three expert packs
of ``Lsub·E`` matrices, and an SSM model is ONE body over all its layers.
The glue calls the functions ``Model.decode_step`` calls (``models/moe``,
``models/ssm``), so the recurrence and the capacity/drop rules have one
copy. A vlm tenant decodes through the dense template (its text path).

Live tuning (``VLIWJit(live_tune=True)``): every coalescer consults a
``LiveTuner`` per plan, which tunes the group's (bm, bn, bk) once per
group signature into the jit's ``tune_cache`` (a mesh device's tuner keys
it with the device id). ``tick`` hands the plan's block to the executor
and to the stacked bodies, whose launches take its ``bm``; ``bn`` and
``bk`` stay modelled (``SuperkernelExecutor.execute``).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import telemetry
from repro_torch.core.autotuner import LiveTuner
from repro_torch.core.clustering import (is_expert_op, op_weight_identity,
                                         op_weight_key, shared_weight_key,
                                         weight_key)
from repro_torch.core.coalescer import Coalescer
from repro_torch.core.costmodel import (BlockConfig, CostModel, GemmShape,
                                        H100)
from repro_torch.core.dispatch import (DispatchStats, SuperkernelExecutor,
                                       _pad_rows_cols, _tile_bucket)
from repro_torch.core.graphs import BodyIO, GlueIO, GraphCache
from repro_torch.core.kernelspec import KernelOp, make_op, op_aspect
from repro_torch.core.plancache import PlanCache, PlanCacheStats
from repro_torch.core.schedtrace import (DispatchRecord, OpRecord,
                                         ProgramAdmit, ScheduleTrace)
from repro_torch.core.scheduler import OoOScheduler, SchedulerConfig
from repro_torch.kernels.build import build_count
from repro_torch.kernels.coalesced_gemm import coalesced_gemm
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.attention import qk_scores
from repro_torch.models.layers import apply_rope, rmsnorm, silu_mul

NEG_INF = -2.0e38


# ---------------------------------------------------------------------------
# kernel programs
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GemmStage:
    tag: str                       # cluster tag, e.g. "ffn_gate"
    weight_key: Tuple              # identity key for operand sharing
    # returns the ORIGINAL weight tensor (the same object every call: the
    # executor's packed-weight guard compares with ``is``)
    weight_fn: Callable[[], torch.Tensor]
    # consumes env, returns the activation matrix [m, k]
    input_fn: Callable[[Dict[str, Any]], torch.Tensor]
    # receives (env, gemm_output)
    output_fn: Callable[[Dict[str, Any], torch.Tensor], None]
    # statically-known problem shape (deadline annotation costs the stage
    # without materializing its weight)
    shape: Optional[GemmShape] = None
    # declared access sets: the env keys input_fn/output_fn touch
    reads: Optional[Tuple] = None
    writes: Optional[Tuple] = None


@dataclasses.dataclass
class GlueStage:
    fn: Callable[[Dict[str, Any]], None]
    reads: Optional[Tuple] = None
    writes: Optional[Tuple] = None
    # the stage as a function of tensors (``fn`` is its eager call), for
    # the per-layer glue the JAX package jits: replayed as a CUDA graph on
    # the card (``VLIWJit.run_glue``)
    graph: Optional[GlueIO] = None


def _glue_stage(io: GlueIO, reads: Tuple, writes: Tuple) -> GlueStage:
    return GlueStage(io.run, reads=reads, writes=writes, graph=io)


def partition_layers(flags: Sequence[bool]) -> List[Tuple[int, int]]:
    """Partition a layer-flag sequence into maximal homogeneous runs:
    half-open ``(lo, hi)`` spans covering ``range(len(flags))`` once, in
    order, with the flag constant inside each span. These are the
    sub-stacks a model with local/global attention alternation runs as
    separate bodies; a homogeneous depth-L model yields ``[(0, L)]``."""
    runs: List[Tuple[int, int]] = []
    lo = 0
    for i in range(1, len(flags)):
        if flags[i] != flags[lo]:
            runs.append((lo, i))
            lo = i
    if len(flags):
        runs.append((lo, len(flags)))
    return runs


@dataclasses.dataclass
class StackedOperand:
    """One stacked weight operand of a layer body: a ``[Lsub, k, n]``
    tensor covering a homogeneous sub-stack. ``shape.layers`` counts the
    operand's sequential tile-waves (Lsub for a dense operand)."""

    tag: str                       # per-layer stage tag, e.g. "ffn_gate"
    weight_key: Tuple              # clustering.weight_key(..., stack=...)
    shape: GemmShape               # per-wave (m, n, k) with layers = waves
    # builds the raw stacked tensor (a [lo:hi) view of the params tree's
    # stacked blocks); runs only on an operand-cache miss
    weight_fn: Callable[[], torch.Tensor]
    # identity guard: the ORIGINAL stacked params tensors (stable across
    # ticks), never per-build slices, which would read as hot-swaps and
    # repack the whole stack every tick
    guard: Tuple = ()


@dataclasses.dataclass
class StackedGemmStage:
    """One layer body: a whole homogeneous sub-stack of layers as a single
    schedulable op (in place of ~6·Lsub ``GemmStage``s). The session
    fetches each operand's padded stack from the executor's persistent
    cache (``SuperkernelExecutor.stacked_operand``) and calls ``run``, a
    loop over the layers that replays the per-layer math with
    ``_scan_gemm`` standing in for the executor's dispatch, bitwise."""

    tag: str                       # body identity, e.g. "body_0_12"
    weight_key: Tuple              # clustering.weight_key("body", stack=...)
    operands: List[StackedOperand]
    layers: int                    # hi - lo
    # run(env, {operand tag -> padded stacked tensor}, executor, block):
    # runs the body and writes its results (residual stream, cache chunk)
    # to env; ``block`` is the dispatch's live-tuned tile or None
    run: Callable[[Dict[str, Any], Dict[str, torch.Tensor],
                   SuperkernelExecutor, Optional[BlockConfig]], None]
    reads: Optional[Tuple] = None
    writes: Optional[Tuple] = None
    # the body as a function of tensors (``run`` is its eager call), the
    # form its CUDA graph holds (core/graphs.py)
    graph: Optional[BodyIO] = None


Stage = Any  # GemmStage | GlueStage | StackedGemmStage


def _scan_gemm(a: torch.Tensor, w_pad: torch.Tensor, n_real: int,
               ex: SuperkernelExecutor,
               block: Optional[BlockConfig] = None) -> torch.Tensor:
    """One GEMM inside a layer body, replicating the executor's dispatch
    of a lone op exactly: the same m-tile bucket, the same padded (K, N)
    envelope (``w_pad`` is one layer of a cached ``stacked_operand``), one
    ``coalesced_gemm`` launch with G = 1 and all-zero group ids. So a
    stacked body is bitwise equal to the per-layer path dispatching each
    stage. It calls the kernel's wrapper directly, so the wrapper's launch
    counters count it. ``block`` is the live-tuned tile of the dispatch
    (None: the executor's default); only its ``bm`` reaches the launch, as
    in ``SuperkernelExecutor.execute``."""
    bm = ex.bm if block is None else block.bm
    m = int(a.shape[0])
    K = int(w_pad.shape[-2])
    m_tiles = _tile_bucket([m], bm)
    ap = _pad_rows_cols(a, m_tiles * bm, K).contiguous()
    out = coalesced_gemm(ap, w_pad[None],
                         ex.group_ids((0,) * m_tiles, a.device), bm=bm)
    return out[:m, :n_real]


def _stack_slice(t: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    return t if lo == 0 and hi == int(t.shape[0]) else t[lo:hi]

# monotonically-increasing KernelProgram instance ids (trace identity)
_PROG_UIDS = itertools.count(1)


@dataclasses.dataclass
class KernelProgram:
    """One tenant step: stages + a private environment."""
    stream_id: int
    stages: List[Stage]
    env: Dict[str, Any]
    pc: int = 0
    slo_s: float = float("inf")
    arrival_t: float = 0.0
    # absolute request deadline; inf falls back to arrival_t + slo_s
    deadline_t: float = float("inf")
    batch: int = 1                 # activation rows (m) of every GEMM stage
    # "decode" (one step of a slotted batch) or "prefill" (a whole prompt
    # pass whose epilogue writes the request's KV rows into the cache)
    kind: str = "decode"
    # (req_id, final deadline) per request batched into this step
    req_deadlines: Tuple = ()
    # KV-cache rows this program writes, as ("kv", owner, slot) resources
    kv_writes: Tuple = ()
    # the mesh device this program's ops run on, stamped at admission by
    # the session that drives that device's timeline
    device: int = 0
    uid: int = dataclasses.field(
        default_factory=lambda: next(_PROG_UIDS), compare=False)
    _gemm_suffix: Optional[List[float]] = dataclasses.field(
        default=None, repr=False, compare=False)
    _suffix_fn: Optional[Callable[[CostModel], List[float]]] = \
        dataclasses.field(default=None, repr=False, compare=False)

    def advance_glue(self, glue: Optional[Callable] = None
                     ) -> Optional[Stage]:
        """Run glue stages until the next GEMM or layer-body stage (or
        completion). ``glue(io, env)`` runs a stage that has a ``GlueIO``
        (the session's ``VLIWJit.run_glue``); without it every stage runs
        its eager ``fn``."""
        while self.pc < len(self.stages):
            st = self.stages[self.pc]
            if isinstance(st, (GemmStage, StackedGemmStage)):
                return st
            if glue is not None and st.graph is not None:
                glue(st.graph, self.env)
            else:
                st.fn(self.env)
            self.pc += 1
        return None

    @property
    def effective_deadline(self) -> float:
        return self.deadline_t if math.isfinite(self.deadline_t) \
            else self.arrival_t + self.slo_s

    def remaining_gemm_time(self, cost: CostModel, pc: int) -> float:
        """Modeled critical-path seconds of the GEMM stages in
        ``stages[pc:]``."""
        if self._gemm_suffix is None:
            if self._suffix_fn is not None:
                self._gemm_suffix = self._suffix_fn(cost)
            else:
                self._gemm_suffix = _gemm_suffix_table(self.stages,
                                                       self.batch, cost)
        return self._gemm_suffix[pc]


def _gemm_suffix_table(stages: List[Stage], batch: int,
                       cost: CostModel) -> List[float]:
    """suffix[i] = modeled seconds of the GEMM stages in ``stages[i:]``."""
    suf = [0.0] * (len(stages) + 1)
    for i in range(len(stages) - 1, -1, -1):
        st = stages[i]
        dt = 0.0
        if isinstance(st, GemmStage):
            shape = st.shape
            if shape is None:
                w = st.weight_fn()
                shape = GemmShape(m=batch, n=int(w.shape[1]),
                                  k=int(w.shape[0]))
            dt = cost.gemm_time(shape)
        elif isinstance(st, StackedGemmStage):
            # each operand's GemmShape carries its wave count in .layers
            dt = sum(cost.gemm_time(od.shape) for od in st.operands)
        suf[i] = suf[i + 1] + dt
    return suf


# ---------------------------------------------------------------------------
# program templates — the unit the plan cache stores
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ProgramTemplate:
    """A compiled-once tenant step: the stage list, glue closures and weight
    keys, with NO per-step state. ``bind()`` rebinds only the per-step
    environment (tokens, KV cache refs, deadlines) into a fresh
    ``KernelProgram``. Templates are keyed by (model identity, batch m,
    dtype, cache geometry) and identity-guarded on the params object."""

    stages: List[Stage]
    batch: int
    model_name: str = ""
    # "decode": tokens bound as [m, 1]; "prefill": tokens bound as
    # [1, batch] — the padded prompt IS the GEMM m dimension
    kind: str = "decode"
    _suffix: Optional[List[float]] = dataclasses.field(
        default=None, repr=False, compare=False)
    _suffix_cost_id: Optional[int] = dataclasses.field(
        default=None, repr=False, compare=False)

    def gemm_suffix(self, cost: CostModel) -> List[float]:
        """Memoized per cost model — bound programs share one table."""
        if self._suffix is None or self._suffix_cost_id != id(cost):
            self._suffix = _gemm_suffix_table(self.stages, self.batch, cost)
            self._suffix_cost_id = id(cost)
        return self._suffix

    def bind(self, *, stream_id: int, tokens: torch.Tensor, cache,
             slo_s: float = float("inf"), arrival_t: float = 0.0,
             deadline_t: float = float("inf"),
             req_deadlines: Tuple = (),
             kv_writes: Tuple = (),
             env_extra: Optional[Dict[str, Any]] = None) -> KernelProgram:
        """Instantiate one step: fresh env + deadlines, shared stages.
        ``env_extra`` merges per-step entries (the prefill path binds
        ``real_len`` / ``slot`` / ``req``)."""
        if self.kind == "prefill":
            assert int(tokens.shape[1]) == self.batch, \
                (tokens.shape, self.batch)
        else:
            assert int(tokens.shape[0]) == self.batch, \
                (tokens.shape, self.batch)
        env: Dict[str, Any] = {"tokens": tokens, "cache": cache,
                               "new_layers": {"k": [], "v": []}}
        if env_extra:
            env.update(env_extra)
        return KernelProgram(stream_id=stream_id, stages=self.stages,
                             env=env, slo_s=slo_s, arrival_t=arrival_t,
                             deadline_t=deadline_t, batch=self.batch,
                             kind=self.kind,
                             req_deadlines=tuple(req_deadlines),
                             kv_writes=tuple(kv_writes),
                             _suffix_fn=self.gemm_suffix)


def dense_program_cache_key(model, params, batch: int, cache, *,
                            stacked: bool = True) -> Tuple:
    """Plan-cache key for a dense decode template: (model identity, active
    batch m, dtype, cache geometry). Params identity is NOT in the key — a
    weight hot-swap lands on the same slot and is caught by the cache's
    identity guard (``guard=(model, params)`` at the lookup site). The
    regime and depth are in the key: a stacked and a per-layer template of
    one model never alias."""
    kc = cache["layers"]["k"]
    return ("dense-decode", model.cfg.name, id(model), batch,
            str(params["embed"].dtype), str(kc.dtype), tuple(kc.shape),
            ("stacked", bool(stacked), model.cfg.num_layers))


# ---------------------------------------------------------------------------
# program builders for dense GQA
# ---------------------------------------------------------------------------

# Views of params tensors, memoized per (base tensor identity, key): the
# per-layer views ``w[l]`` of the stacked [L, ...] params and the tied
# unembed ``embed.T``. Every template of one params tree — decode at any
# batch size, prefill at any bucket, one per tenant — must hand the executor
# the SAME view object for one weight key. Its packed-weight cache guards on
# identity, and its shared regime requires equal keys to mean the identical
# tensor; a fresh view per template breaks both (the JAX package's
# per-layer regime, which slices per template, raises OperandIdentityHazard
# when two templates of one params tree coalesce), and would repack the
# model's largest matrix on every batch-size flip. Base and view are held
# weakly, so discarding an engine frees them; the base ref doubles as the
# id-recycling guard.
_VIEWS: Dict[Tuple[int, object], Tuple["weakref.ref", "weakref.ref"]] = {}


def _stable_view(base: torch.Tensor, key, make) -> torch.Tensor:
    """``make(base)``, the same object on every call while it lives."""
    ent = _VIEWS.get((id(base), key))
    if ent is not None:
        b, view = ent[0](), ent[1]()
        if b is base and view is not None:
            return view
    view = make(base)
    if len(_VIEWS) > 4096:                 # prune dead refs opportunistically
        for k in [k for k, (b, v) in _VIEWS.items()
                  if b() is None or v() is None]:
            del _VIEWS[k]
    _VIEWS[(id(base), key)] = (weakref.ref(base), weakref.ref(view))
    return view


def _layer_views(blocks, l: int):
    """Layer ``l``'s params as (memoized) views into the stacked tree."""
    return {k: (_layer_views(v, l) if isinstance(v, dict)
                else _stable_view(v, l, lambda w: w[l]))
            for k, v in blocks.items()}


def _emit_dense_body(cfg: ModelConfig, params, stages: List[Stage], *,
                     m_rows: int, attend_for, ffn_for=None,
                     attend_reads: Tuple = ("wq", "wk", "wv", "cache")
                     ) -> None:
    """Emit the per-layer stage scaffolding shared by the dense DECODE and
    PREFILL builders: pre-norm, the wq/wk/wv projections, the phase-specific
    attention glue (``attend_for(l, lp, is_global)``, a ``GlueIO``: the
    JAX package jits it), wo, post-norm and the
    gated FFN. Exactly one copy: cross-phase operand sharing requires both
    builders to emit identical weight keys and tags.

    ``m_rows`` is the activation-row count of every GEMM stage — the slotted
    batch for decode, the padded prompt length for prefill.

    ``ffn_for(l, lp, stages)``, when given, replaces layer ``l``'s gated-FFN
    emission (the MoE builder's router glue and per-expert GEMMs); it reads
    ``env['h2']`` and leaves ``env['x']`` with the FFN residual added. The
    attention scaffolding stays this one copy, so MoE attention GEMMs
    coalesce with dense tenants'."""
    hd = cfg.resolved_head_dim
    blocks = params["blocks"]
    # weight identity includes the params object: two tenants share
    # operands only when they serve the very same weights
    pid = id(params)

    def glue(fn, reads=None, writes=None):
        stages.append(GlueStage(fn, reads=reads, writes=writes))

    def gemm(tag, wkey, wfn, infn, outfn, n, k, reads, writes):
        stages.append(GemmStage(tag, wkey, wfn, infn, outfn,
                                shape=GemmShape(m=m_rows, n=n, k=k),
                                reads=reads, writes=writes))

    for l in range(cfg.num_layers):
        lp = _layer_views(blocks, l)
        is_global = cfg.layer_is_global(l)

        def pre_attn(env, lp=lp):
            env["h"] = rmsnorm(env["x"], lp["ln1"], cfg.norm_eps)

        glue(pre_attn, reads=("x",), writes=("h",))
        for name, n_heads in (("wq", cfg.num_heads), ("wk", cfg.num_kv_heads),
                              ("wv", cfg.num_kv_heads)):
            gemm(f"attn_{name}", weight_key(cfg.name, pid, name, layer=l),
                 lambda lp=lp, name=name: lp["attn"][name],
                 lambda env: env["h"],
                 lambda env, out, name=name: env.__setitem__(name, out),
                 n_heads * hd, cfg.d_model, ("h",), (name,))

        stages.append(_glue_stage(attend_for(l, lp, is_global),
                                  attend_reads, ("attn_out", "new_layers")))
        gemm("attn_wo", weight_key(cfg.name, pid, "wo", layer=l),
             lambda lp=lp: lp["attn"]["wo"],
             lambda env: env["attn_out"],
             lambda env, out: env.__setitem__("attn_proj", out),
             cfg.d_model, cfg.num_heads * hd, ("attn_out",), ("attn_proj",))

        def post_attn(env, lp=lp):
            env["x"] = env["x"] + env["attn_proj"]
            env["h2"] = rmsnorm(env["x"], lp["ln2"], cfg.norm_eps)

        glue(post_attn, reads=("x", "attn_proj"), writes=("x", "h2"))
        if ffn_for is not None:
            ffn_for(l, lp, stages)
            continue
        gemm("ffn_gate", weight_key(cfg.name, pid, "w_gate", layer=l),
             lambda lp=lp: lp["mlp"]["w_gate"],
             lambda env: env["h2"],
             lambda env, out: env.__setitem__("gate", out),
             cfg.d_ff, cfg.d_model, ("h2",), ("gate",))
        gemm("ffn_up", weight_key(cfg.name, pid, "w_up", layer=l),
             lambda lp=lp: lp["mlp"]["w_up"],
             lambda env: env["h2"],
             lambda env, out: env.__setitem__("up", out),
             cfg.d_ff, cfg.d_model, ("h2",), ("up",))

        def act(env):
            env["act"] = silu_mul(env["gate"], env["up"])

        glue(act, reads=("gate", "up"), writes=("act",))
        gemm("ffn_down", weight_key(cfg.name, pid, "w_down", layer=l),
             lambda lp=lp: lp["mlp"]["w_down"],
             lambda env: env["act"],
             lambda env, out: env.__setitem__("down", out),
             cfg.d_model, cfg.d_ff, ("act",), ("down",))

        def post_ffn(env):
            env["x"] = env["x"] + env["down"]

        glue(post_ffn, reads=("x", "down"), writes=("x",))


# sqrt(d_model) on a device in a dtype, made once: a host-to-device copy
# an embed otherwise
_EMBED_SCALES: Dict[Tuple[int, str, torch.dtype], torch.Tensor] = {}


def _embed_scale(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """sqrt(d_model) as a float32 scalar cast to ``x``'s dtype (the JAX
    package's ``jnp.asarray(jnp.sqrt(d), x.dtype)``), one tensor per
    (d_model, device, dtype)."""
    key = (cfg.d_model, str(x.device), x.dtype)
    scale = _EMBED_SCALES.get(key)
    if scale is None:
        scale = _EMBED_SCALES[key] = torch.tensor(
            math.sqrt(cfg.d_model), dtype=torch.float32,
            device=x.device).to(x.dtype)
    return scale


def _emit_decode_embed(cfg: ModelConfig, params, stages: List[Stage]) -> None:
    """Token-embedding prologue of the decode builder: scaled embed of the
    step's [B, 1] tokens squeezed to [B, d], plus the cache-position
    snapshot."""

    def embed(env):
        x = params["embed"][env["tokens"]]
        env["x"] = (x * _embed_scale(cfg, x))[:, 0]
        env["pos"] = env["cache"]["pos"]

    stages.append(GlueStage(embed, reads=("tokens", "cache"),
                            writes=("x", "pos")))


def _emit_final_logits(cfg: ModelConfig, params, stages: List[Stage], *,
                       m_rows: int) -> None:
    """Final-norm + unembed tail of the decode builder."""

    def final_norm(env):
        env["hf"] = rmsnorm(env["x"], params["final_norm"], cfg.norm_eps)

    stages.append(GlueStage(final_norm, reads=("x",), writes=("hf",)))
    _emit_unembed(cfg, params, stages, m_rows=m_rows)


def _emit_unembed(cfg: ModelConfig, params, stages: List[Stage], *,
                  m_rows: int) -> None:
    """Emit the unembedding GEMM over ``env['hf']`` into ``env['logits']``
    (shared by both builders; ``m_rows`` = the normed rows to unembed)."""
    pid = id(params)
    if cfg.tie_embeddings:
        wT = _stable_view(params["embed"], "T", lambda e: e.T)
        wfn, n = (lambda: wT), int(params["embed"].shape[0])
    else:
        wfn, n = (lambda: params["unembed"]), int(params["unembed"].shape[1])
    stages.append(GemmStage(
        "unembed", weight_key(cfg.name, pid, "unembed"), wfn,
        lambda env: env["hf"],
        lambda env, out: env.__setitem__("logits", out),
        shape=GemmShape(m=m_rows, n=n, k=cfg.d_model),
        reads=("hf",), writes=("logits",)))


def _gqa_decode_attend(cfg: ModelConfig, B: int, q_flat, k_flat, v_flat,
                       kc, vc, pos, is_global: bool, out_dtype
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One layer of single-token slotted-cache GQA attention. ``kc``/``vc``
    are the layer's cache slices [B, Hkv, S, hd]; ``pos`` [B] the per-row
    write index. Returns (attn_out [B, H·hd], new kc, new vc) — the caches
    are new tensors, the inputs are left as they were."""
    hd = cfg.resolved_head_dim
    q = q_flat.reshape(B, 1, cfg.num_heads, hd)
    k = k_flat.reshape(B, 1, cfg.num_kv_heads, hd)
    v = v_flat.reshape(B, 1, cfg.num_kv_heads, hd)
    pos = pos.long()
    posb = pos[:, None]
    q = apply_rope(q, posb, cfg.rope_theta)
    k = apply_rope(k, posb, cfg.rope_theta)
    rows = torch.arange(B, device=kc.device)
    kc = kc.clone()
    vc = vc.clone()
    S = kc.shape[2]
    # the JAX package's dynamic_update_slice clamps the write into the
    # cache: an idle slot, whose position keeps advancing while the
    # tenant decodes, writes its last entry instead of raising
    wpos = pos.clamp(max=S - 1)
    kc[rows, :, wpos] = k[:, 0].to(kc.dtype)
    vc[rows, :, wpos] = v[:, 0].to(vc.dtype)
    G = cfg.num_heads // cfg.num_kv_heads
    qg = q.reshape(B, 1, cfg.num_kv_heads, G, hd)
    scores = qk_scores(qg, kc, k_heads_first=True)
    scores = scores / math.sqrt(hd)
    idx = torch.arange(S, device=kc.device)
    ok = idx[None, :] <= pos[:, None]
    if cfg.window_size > 0 and not is_global:
        ok = ok & (idx[None, :] > (pos[:, None] - cfg.window_size))
    scores = torch.where(ok[:, None, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhgst,bhtd->bshgd", p, vc.float())
    return o.reshape(B, cfg.num_heads * hd).to(out_dtype), kc, vc


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _write_attend(env, outs: Dict[str, torch.Tensor]) -> None:
    """An attention glue stage's outputs into the env: the layer's new
    k / v (its cache slices, or the prompt's rows) and ``attn_out``."""
    env["new_layers"]["k"].append(outs["k"])
    env["new_layers"]["v"].append(outs["v"])
    env["attn_out"] = outs["attn_out"]


def _decode_attend_for(cfg: ModelConfig, B: int):
    """Single-token slotted-cache attention glue factory: the JAX
    package's ``decode-attend`` glue jit, keyed (cfg, B, is_global, out
    dtype), its arguments q / k / v, the layer's cache slices and pos."""

    def attend_for(l, lp, is_global):
        def bind(env):
            cache = env["cache"]
            out_dtype = env["h"].dtype

            def attend(inp):
                attn_out, kc, vc = _gqa_decode_attend(
                    cfg, B, inp["q"], inp["k"], inp["v"], inp["kc"],
                    inp["vc"], inp["pos"], is_global, out_dtype)
                return {"attn_out": attn_out, "k": kc, "v": vc}

            key = ("decode-attend", cfg, B, bool(is_global),
                   _dtype_name(out_dtype))
            return key, attend, {
                "q": env["wq"], "k": env["wk"], "v": env["wv"],
                "kc": cache["layers"]["k"][l], "vc": cache["layers"]["v"][l],
                "pos": torch.broadcast_to(cache["pos"], (B,))}

        return GlueIO(bind, _write_attend)

    return attend_for


def _moe_route(cfg: ModelConfig, router: torch.Tensor, h2: torch.Tensor,
               C: int):
    """Router and sort-based dispatch of one decode step's B tokens as one
    group (``moe_ffn``'s G = 1 path): (buf [E, C, d], meta, weights
    [B, k]). The glue of both MoE regimes."""
    mcfg = cfg.moe
    weights, experts, _aux = moe_lib.route(router, h2, mcfg)
    buf, meta = moe_lib.dispatch_tokens(h2, weights, experts,
                                        mcfg.num_experts, mcfg.top_k, C)
    return buf, meta, weights


def _moe_combine(cfg: ModelConfig, out_buf: torch.Tensor, weights,
                 meta) -> torch.Tensor:
    """The experts' stacked [E, C, d] outputs combined back to the B
    tokens (fp32): the FFN residual of one MoE layer before its cast to the
    residual's dtype. The glue of both MoE regimes."""
    B = int(weights.shape[0])
    return moe_lib.combine_tokens(out_buf, weights.reshape(-1), meta, B,
                                  cfg.d_model)


def _metas(tensors: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """The dispatch's meta tuple from its ``meta<i>`` entries."""
    return tuple(tensors[f"meta{i}"] for i in range(
        sum(k.startswith("meta") for k in tensors)))


def _ssm_core(cfg: ModelConfig, mamba_p, zxbcdt: torch.Tensor,
              conv: torch.Tensor, h: torch.Tensor):
    """The selective-scan recurrence between a layer's two projections
    (``ssm.decode_core``): (y [B, d_inner], new {"conv", "h"})."""
    return ssm_lib.decode_core(mamba_p, zxbcdt, {"conv": conv, "h": h},
                               cfg.ssm, cfg.d_model)


def _stacked_body_stage(cfg: ModelConfig, params, lo: int, hi: int, *,
                        m_rows: int, read, attend_for, reads: Tuple,
                        graph_key: Tuple, moe: bool = False
                        ) -> StackedGemmStage:
    """ONE layer body covering layers [lo, hi) of a GQA model (dense or,
    with ``moe``, MoE), in place of their per-layer stages; shared by the
    decode and prefill templates, as ``_emit_dense_body`` is. Its loop
    replays the per-layer math exactly: ``_scan_gemm`` for every projection
    and the same ``rmsnorm``, ``silu_mul`` and MoE glue (``_moe_route``,
    ``_moe_combine``) the per-layer glue calls. The body is a function of
    tensors (``BodyIO``): ``read(env, lo, hi)`` gives its inputs (``x`` and
    the phase's own), ``attend_for(inputs, is_global)`` the phase's
    attention, ``attend(i, q, k, v, dtype) -> (attn_out, k_new, v_new)``
    for the body's layer i, the same function its per-layer glue calls.
    The layers' k/v are stacked into one [Lsub, ...] chunk for the epilogue
    to concatenate. An MoE body's expert packs hold ``Lsub·E`` matrices,
    layer i's expert e at ``i·E + e``. ``graph_key`` ((phase, cfg, batch or
    prompt bucket): ``BodyIO.key``) lets the session replay the body as a
    CUDA graph (core/graphs.py)."""
    hd = cfg.resolved_head_dim
    d = cfg.d_model
    eps = cfg.norm_eps
    blocks = params["blocks"]
    pid = id(params)
    Lsub = hi - lo
    is_global = bool(cfg.layer_is_global(lo))
    nq, nkv, dff = cfg.num_heads * hd, cfg.num_kv_heads * hd, cfg.d_ff
    operands = _stacked_operands(cfg, blocks, pid, lo, hi, m=m_rows, moe=moe)
    ln1s = _stack_slice(blocks["ln1"], lo, hi)
    ln2s = _stack_slice(blocks["ln2"], lo, hi)
    if moe:
        E = cfg.moe.num_experts
        C = moe_lib.capacity(m_rows, cfg.moe)
        routers = _stack_slice(blocks["moe"]["router"], lo, hi)

    def body(inp, padded, ex, block=None):
        attend = attend_for(inp, is_global)

        def gemm(a, tag, j, n):
            return _scan_gemm(a, padded[tag][j], n, ex, block)

        x = inp["x"]
        ks, vs = [], []
        for i in range(Lsub):
            h = rmsnorm(x, ln1s[i], eps)
            attn_out, k_new, v_new = attend(
                i, gemm(h, "attn_wq", i, nq), gemm(h, "attn_wk", i, nkv),
                gemm(h, "attn_wv", i, nkv), h.dtype)
            ks.append(k_new)
            vs.append(v_new)
            x = x + gemm(attn_out, "attn_wo", i, d)
            h2 = rmsnorm(x, ln2s[i], eps)
            if moe:
                buf, meta, wgt = _moe_route(cfg, routers[i], h2, C)
                downs = []
                for e in range(E):
                    j = i * E + e
                    act = silu_mul(gemm(buf[e], "expert_gate", j, dff),
                                   gemm(buf[e], "expert_up", j, dff))
                    downs.append(gemm(act, "expert_down", j, d))
                x = x + _moe_combine(cfg, torch.stack(downs), wgt,
                                     meta).to(h2.dtype)
                continue
            act = silu_mul(gemm(h2, "ffn_gate", i, dff),
                           gemm(h2, "ffn_up", i, dff))
            x = x + gemm(act, "ffn_down", i, d)
        return {"x": x, "k": torch.stack(ks), "v": torch.stack(vs)}

    io = BodyIO(graph_key, lambda env: read(env, lo, hi), body)
    return StackedGemmStage(
        tag=f"body_{lo}_{hi}",
        weight_key=weight_key(cfg.name, pid, "body", stack=(lo, hi)),
        operands=operands, layers=Lsub, run=io.run,
        reads=reads, writes=("x", "new_layers"),
        graph=io)


def _stacked_operands(cfg: ModelConfig, blocks, pid: int, lo: int, hi: int,
                      *, m: int, moe: bool = False) -> List[StackedOperand]:
    """The stacked projection operands of a body over layers [lo, hi), in
    the per-layer emission's order, each guarded on the ORIGINAL stacked
    params tensor: wq, wk, wv, wo, then the gated FFN's three or, for MoE,
    the three expert packs. An expert pack flattens the [Lsub, E, k, n]
    slice to [Lsub·E, k, n] (a view) and keeps the ``expert_*`` tag, which
    ``clustering.is_expert_op`` reads; it counts ``Lsub·E`` sequential
    waves of m = C rows."""
    hd = cfg.resolved_head_dim
    d = cfg.d_model
    attn = blocks["attn"]
    Lsub = hi - lo

    def sop(tag, name, t, n, k, rows=m, waves=Lsub):
        def weight_fn(t=t):
            w = _stack_slice(t, lo, hi)
            return w.reshape(waves, k, n) if w.dim() == 4 else w

        return StackedOperand(
            tag, weight_key(cfg.name, pid, name, stack=(lo, hi)),
            GemmShape(m=rows, n=n, k=k, layers=waves), weight_fn, (t,))

    ops = [
        sop("attn_wq", "wq", attn["wq"], cfg.num_heads * hd, d),
        sop("attn_wk", "wk", attn["wk"], cfg.num_kv_heads * hd, d),
        sop("attn_wv", "wv", attn["wv"], cfg.num_kv_heads * hd, d),
        sop("attn_wo", "wo", attn["wo"], d, cfg.num_heads * hd),
    ]
    if moe:
        mp = blocks["moe"]
        C = moe_lib.capacity(m, cfg.moe)
        waves = Lsub * cfg.moe.num_experts
        return ops + [
            sop("expert_gate", "w_gate", mp["w_gate"], cfg.d_ff, d, C, waves),
            sop("expert_up", "w_up", mp["w_up"], cfg.d_ff, d, C, waves),
            sop("expert_down", "w_down", mp["w_down"], d, cfg.d_ff, C, waves),
        ]
    mlp = blocks["mlp"]
    return ops + [
        sop("ffn_gate", "w_gate", mlp["w_gate"], cfg.d_ff, d),
        sop("ffn_up", "w_up", mlp["w_up"], cfg.d_ff, d),
        sop("ffn_down", "w_down", mlp["w_down"], d, cfg.d_ff),
    ]


def _join_chunks(chunks: List[torch.Tensor]) -> torch.Tensor:
    """The bodies' [Lsub, ...] cache chunks joined into [L, ...]. A model
    of one body already has its [L, ...] tensor (new, made by its body),
    so it is taken as it is rather than copied."""
    return chunks[0] if len(chunks) == 1 else torch.cat(chunks, dim=0)


def _decode_finish(concat, keys: Tuple[str, ...] = ("k", "v")):
    """The decode epilogue: ``pos + 1`` and the layers' new caches (k / v,
    or an SSM's conv / h) joined into [L, ...] (``torch.stack`` of
    per-layer tensors, ``torch.cat`` of per-body chunks) as new cache
    tensors."""

    def finish(env):
        cache = env["cache"]
        env["cache"] = {
            "pos": cache["pos"] + 1,
            "layers": {k: concat(env["new_layers"][k]) for k in keys},
        }

    return GlueStage(finish, reads=("cache", "new_layers"),
                     writes=("cache",))


def _build_stacked_gqa_decode_template(model, params, batch: int, *,
                                       moe: bool = False) -> ProgramTemplate:
    """Stacked counterpart of ``_build_gqa_decode_template``: one body
    stage per homogeneous sub-stack instead of per-layer emission (MoE
    bodies with ``moe``)."""
    cfg: ModelConfig = model.cfg
    B = batch

    def read(env, lo, hi):
        # the body's inputs: the residual stream, the rows' positions and
        # the body's slices of the slotted cache
        cache = env["cache"]
        return {"x": env["x"], "pos": torch.broadcast_to(cache["pos"], (B,)),
                "kc": _stack_slice(cache["layers"]["k"], lo, hi),
                "vc": _stack_slice(cache["layers"]["v"], lo, hi)}

    def attend_for(inp, is_global):
        # one new token per row against the slotted cache
        kc, vc, pos = inp["kc"], inp["vc"], inp["pos"]

        def attend(i, q, k, v, dtype):
            return _gqa_decode_attend(cfg, B, q, k, v, kc[i], vc[i], pos,
                                      is_global, dtype)

        return attend

    stages: List[Stage] = []
    _emit_decode_embed(cfg, params, stages)
    for lo, hi in partition_layers(cfg.global_layer_flags()):
        stages.append(_stacked_body_stage(
            cfg, params, lo, hi, m_rows=B, read=read, attend_for=attend_for,
            reads=("x", "cache"), moe=moe, graph_key=("decode", cfg, B)))
    _emit_final_logits(cfg, params, stages, m_rows=B)
    stages.append(_decode_finish(_join_chunks))
    return ProgramTemplate(stages=stages, batch=B, model_name=cfg.name)


def _build_gqa_decode_template(model, params, batch: int, *,
                               ffn_for=None) -> ProgramTemplate:
    """Decode-template scaffold of every GQA family: embed glue, the
    per-layer attention + FFN body (``ffn_for`` swaps the gated FFN for the
    MoE emitter), final norm, unembed and the KV-cache write-back
    epilogue."""
    cfg: ModelConfig = model.cfg
    B = batch
    stages: List[Stage] = []

    _emit_decode_embed(cfg, params, stages)
    _emit_dense_body(cfg, params, stages, m_rows=B,
                     attend_for=_decode_attend_for(cfg, B), ffn_for=ffn_for)
    _emit_final_logits(cfg, params, stages, m_rows=B)
    stages.append(_decode_finish(torch.stack))
    return ProgramTemplate(stages=stages, batch=B, model_name=cfg.name)


def build_dense_decode_template(model, params, batch: int, *,
                                stacked: bool = True) -> ProgramTemplate:
    """Compile the decode step of a dense GQA model into a ProgramTemplate.

    Equivalent to ``Model.decode_step`` but with every projection GEMM
    declared to the JIT. Supported: arch_type "dense" and the text path of
    "vlm" (its decode step is a dense stack; the patch prefix lives in the
    cache from the prompt). Per-step inputs (tokens [B, 1], KV cache) are
    read from the bound program's env, so one template serves every step.
    ``stacked=True`` (default) emits one layer body per homogeneous
    sub-stack; ``stacked=False`` the per-layer stages."""
    assert model.cfg.arch_type in ("dense", "vlm"), model.cfg.arch_type
    if stacked:
        return _build_stacked_gqa_decode_template(model, params, batch)
    return _build_gqa_decode_template(model, params, batch)


# ---------------------------------------------------------------------------
# non-dense decode programs: MoE and SSM tenants as first-class streams
# ---------------------------------------------------------------------------

def moe_program_cache_key(model, params, batch: int, cache, *,
                          stacked: bool = True) -> Tuple:
    """Plan-cache key for an MoE decode template, on the discipline of
    ``dense_program_cache_key`` (params identity is guarded at the lookup
    site). The expert capacity C is a function of (batch, cfg.moe), both
    in the key through the batch and the model's identity."""
    kc = cache["layers"]["k"]
    return ("moe-decode", model.cfg.name, id(model), batch,
            str(params["embed"].dtype), str(kc.dtype), tuple(kc.shape),
            ("stacked", bool(stacked), model.cfg.num_layers))


def build_moe_decode_template(model, params, batch: int, *,
                              stacked: bool = True) -> ProgramTemplate:
    """Compile the decode step of an MoE model into a ProgramTemplate,
    equivalent to ``Model.decode_step`` for arch_type "moe".

    The attention scaffolding is the dense builder's own emission (so MoE
    attention GEMMs coalesce with dense tenants'); each layer's FFN becomes
    a glue stage running the router and the sort-based capacity dispatch
    (``_moe_route``: ``moe.route`` / ``dispatch_tokens``, the code
    ``moe_ffn`` runs), 3·E per-expert ``GemmStage``s over the [C, d]
    expert buffer, tagged ``expert_*`` with the expert index in the weight
    key, and a combine glue. The expert slices are made once here and held
    through ``_stable_view``, so the executor's identity guard never sees a
    phantom hot-swap. ``stacked=True`` (default) runs the same glue inside
    one body per sub-stack whose three expert packs are [Lsub·E, k, n];
    ``stacked=False`` keeps the per-layer stages (the bitwise oracle)."""
    cfg: ModelConfig = model.cfg
    assert cfg.arch_type == "moe" and cfg.has_moe, cfg.arch_type
    if stacked:
        return _build_stacked_gqa_decode_template(model, params, batch,
                                                  moe=True)
    mcfg = cfg.moe
    B, d = batch, cfg.d_model
    E = mcfg.num_experts
    # decode routes the step's B tokens as one group (moe_ffn's G = 1)
    C = moe_lib.capacity(B, mcfg)
    pid = id(params)
    mp = params["blocks"]["moe"]

    def route(inp):
        buf, meta, weights = _moe_route(cfg, inp["router"], inp["h2"], C)
        return {"buf": buf, "weights": weights,
                **{f"meta{i}": t for i, t in enumerate(meta)}}

    def route_write(env, outs):
        env["moe_buf"], env["moe_w"] = outs["buf"], outs["weights"]
        env["moe_meta"] = _metas(outs)
        env["moe_down"] = [None] * E

    def combine(inp):
        return {"y": _moe_combine(cfg, inp["out_buf"], inp["weights"],
                                  _metas(inp))}

    def combine_write(env, outs):
        env["x"] = env["x"] + outs["y"].to(env["h2"].dtype)

    def ffn_for(l, lp, stages):
        router = lp["moe"]["router"]

        def glue(fn, reads=None, writes=None):
            stages.append(GlueStage(fn, reads=reads, writes=writes))

        # the JAX package's ``moe-route`` glue jit: its arguments the
        # layer's router and h2
        def route_bind(env):
            return ("moe-route", cfg, B, C), route, {"router": router,
                                                     "h2": env["h2"]}

        stages.append(_glue_stage(
            GlueIO(route_bind, route_write), reads=("h2",),
            writes=("moe_buf", "moe_meta", "moe_w", "moe_down")))
        for e in range(E):
            wg, wu, wd = (_stable_view(mp[name], (l, e),
                                       lambda w, e=e: w[l, e])
                          for name in ("w_gate", "w_up", "w_down"))
            for tag, name, w, out in (("expert_gate", "w_gate", wg,
                                       ("moe_gate", e)),
                                      ("expert_up", "w_up", wu,
                                       ("moe_up", e))):
                stages.append(GemmStage(
                    tag, weight_key(cfg.name, pid, name, layer=l, expert=e),
                    lambda w=w: w,
                    lambda env, e=e: env["moe_buf"][e],
                    lambda env, o, out=out: env.__setitem__(out, o),
                    shape=GemmShape(m=C, n=cfg.d_ff, k=d),
                    reads=("moe_buf",), writes=(out,)))

            def act(env, e=e):
                env[("moe_act", e)] = silu_mul(env.pop(("moe_gate", e)),
                                               env.pop(("moe_up", e)))

            glue(act, reads=(("moe_gate", e), ("moe_up", e)),
                 writes=(("moe_act", e),))
            stages.append(GemmStage(
                "expert_down",
                weight_key(cfg.name, pid, "w_down", layer=l, expert=e),
                lambda w=wd: w,
                lambda env, e=e: env[("moe_act", e)],
                lambda env, o, e=e: env["moe_down"].__setitem__(e, o),
                shape=GemmShape(m=C, n=d, k=cfg.d_ff),
                reads=(("moe_act", e),), writes=("moe_down",)))

        # the JAX package's ``moe-combine`` glue jit: the experts' outputs
        # stacked ahead of it, the cast and the residual add after it
        def combine_bind(env):
            env.pop("moe_buf")
            inputs = {"out_buf": torch.stack(env.pop("moe_down")),
                      "weights": env.pop("moe_w")}
            for i, t in enumerate(env.pop("moe_meta")):
                inputs[f"meta{i}"] = t
            return ("moe-combine", cfg, B), combine, inputs

        stages.append(_glue_stage(
            GlueIO(combine_bind, combine_write),
            reads=("moe_down", "moe_w", "moe_meta", "moe_buf", "x", "h2"),
            writes=("x",)))

    return _build_gqa_decode_template(model, params, batch, ffn_for=ffn_for)


def ssm_program_cache_key(model, params, batch: int, cache, *,
                          stacked: bool = True) -> Tuple:
    """Plan-cache key for an SSM decode template: (model identity, batch,
    dtype, recurrent-cache geometry); guard discipline as for dense."""
    cc = cache["layers"]["conv"]
    return ("ssm-decode", model.cfg.name, id(model), batch,
            str(params["embed"].dtype), str(cc.dtype), tuple(cc.shape),
            tuple(cache["layers"]["h"].shape),
            ("stacked", bool(stacked), model.cfg.num_layers))


def _reset_ssm_layers(env):
    env["new_layers"] = {"conv": [], "h": []}


def _build_stacked_ssm_decode_template(model, params, batch: int
                                       ) -> ProgramTemplate:
    """Stacked counterpart of the per-layer SSM builder: an attention-free
    stack is one homogeneous sub-stack, so ONE body stage declares the
    stacked in / out projections and runs the recurrence (``_ssm_core``,
    the per-layer glue's function) between them, layer by layer."""
    cfg: ModelConfig = model.cfg
    scfg = cfg.ssm
    B, d = batch, cfg.d_model
    d_inner = scfg.expand * d
    n_in = 2 * d_inner + 2 * scfg.d_state + scfg.num_heads(d)
    eps = cfg.norm_eps
    blocks = params["blocks"]
    mamba = blocks["mamba"]
    pid = id(params)
    L = cfg.num_layers
    operands = [
        StackedOperand(
            "ssm_in_proj", weight_key(cfg.name, pid, "in_proj",
                                      stack=(0, L)),
            GemmShape(m=B, n=n_in, k=d, layers=L),
            lambda: mamba["in_proj"], (mamba["in_proj"],)),
        StackedOperand(
            "ssm_out_proj", weight_key(cfg.name, pid, "out_proj",
                                       stack=(0, L)),
            GemmShape(m=B, n=d, k=d_inner, layers=L),
            lambda: mamba["out_proj"], (mamba["out_proj"],)),
    ]
    # the recurrence reads the conv / dt / A / D / norm leaves; the
    # projections are the stacked operands above
    rest = [{k: v[l] for k, v in mamba.items()
             if k not in ("in_proj", "out_proj")} for l in range(L)]
    ln1s = blocks["ln1"]

    def read(env):
        # the body's inputs: the residual stream and the recurrent cache
        layers = env["cache"]["layers"]
        return {"x": env["x"], "conv": layers["conv"], "h": layers["h"]}

    def body(inp, padded, ex, block=None):
        x = inp["x"]
        convs, hs = [], []
        for l in range(L):
            hh = rmsnorm(x, ln1s[l], eps)
            zxbcdt = _scan_gemm(hh, padded["ssm_in_proj"][l], n_in, ex,
                                block)
            y, new_c = _ssm_core(cfg, rest[l], zxbcdt, inp["conv"][l],
                                 inp["h"][l])
            x = x + _scan_gemm(y, padded["ssm_out_proj"][l], d, ex, block)
            convs.append(new_c["conv"])
            hs.append(new_c["h"])
        return {"x": x, "conv": torch.stack(convs), "h": torch.stack(hs)}

    io = BodyIO(("decode", cfg, B), read, body)

    stages: List[Stage] = []
    _emit_decode_embed(cfg, params, stages)
    stages.append(GlueStage(_reset_ssm_layers, reads=(),
                            writes=("new_layers",)))
    stages.append(StackedGemmStage(
        tag=f"body_0_{L}",
        weight_key=weight_key(cfg.name, pid, "body", stack=(0, L)),
        operands=operands, layers=L, run=io.run,
        reads=("x", "cache"), writes=("x", "new_layers"), graph=io))
    _emit_final_logits(cfg, params, stages, m_rows=B)
    stages.append(_decode_finish(_join_chunks,
                                 keys=("conv", "h")))
    return ProgramTemplate(stages=stages, batch=B, model_name=cfg.name)


def build_ssm_decode_template(model, params, batch: int, *,
                              stacked: bool = True) -> ProgramTemplate:
    """Compile the decode step of an attention-free SSM (Mamba-2) model
    into a ProgramTemplate, equivalent to ``Model.decode_step`` for
    arch_type "ssm": per layer, the in projection and the out projection
    are declared ``GemmStage``s (coalescible across tenants) and the
    recurrence between them runs as glue (``_ssm_core``: the function
    ``ssd_decode_step`` calls). The epilogue stacks the layers' conv
    windows and states back into the recurrent cache. ``stacked=True``
    (default) runs one body over all the layers; ``stacked=False`` the
    per-layer stages (the bitwise oracle)."""
    cfg: ModelConfig = model.cfg
    assert cfg.arch_type == "ssm" and cfg.has_ssm, cfg.arch_type
    if stacked:
        return _build_stacked_ssm_decode_template(model, params, batch)
    scfg = cfg.ssm
    B, d = batch, cfg.d_model
    d_inner = scfg.expand * d
    n_in = 2 * d_inner + 2 * scfg.d_state + scfg.num_heads(d)
    blocks = params["blocks"]
    pid = id(params)
    stages: List[Stage] = []

    def glue(fn, reads=None, writes=None):
        stages.append(GlueStage(fn, reads=reads, writes=writes))

    def scan(inp):
        y, new_c = _ssm_core(cfg, inp, inp["zxbcdt"], inp["conv"], inp["h"])
        return {"y": y, "conv": new_c["conv"], "h": new_c["h"]}

    def scan_write(env, outs):
        env["new_layers"]["conv"].append(outs["conv"])
        env["new_layers"]["h"].append(outs["h"])
        env["ssm_y"] = outs["y"]

    _emit_decode_embed(cfg, params, stages)
    glue(_reset_ssm_layers, reads=(), writes=("new_layers",))
    for l in range(cfg.num_layers):
        lp = _layer_views(blocks, l)

        def pre(env, lp=lp):
            env["h"] = rmsnorm(env["x"], lp["ln1"], cfg.norm_eps)

        glue(pre, reads=("x",), writes=("h",))
        stages.append(GemmStage(
            "ssm_in_proj", weight_key(cfg.name, pid, "in_proj", layer=l),
            lambda lp=lp: lp["mamba"]["in_proj"],
            lambda env: env["h"],
            lambda env, out: env.__setitem__("zxbcdt", out),
            shape=GemmShape(m=B, n=n_in, k=d),
            reads=("h",), writes=("zxbcdt",)))

        # the JAX package's ``ssm-core`` glue jit: its arguments the
        # recurrence's mamba leaves, zxbcdt and the layer's recurrent cache
        def scan_bind(env, lp=lp, l=l):
            layers = env["cache"]["layers"]
            inputs = {k: v for k, v in lp["mamba"].items()
                      if k not in ("in_proj", "out_proj")}
            inputs.update(zxbcdt=env.pop("zxbcdt"), conv=layers["conv"][l],
                          h=layers["h"][l])
            return ("ssm-core", cfg), scan, inputs

        stages.append(_glue_stage(GlueIO(scan_bind, scan_write),
                                  reads=("cache", "zxbcdt"),
                                  writes=("new_layers", "ssm_y")))
        stages.append(GemmStage(
            "ssm_out_proj", weight_key(cfg.name, pid, "out_proj", layer=l),
            lambda lp=lp: lp["mamba"]["out_proj"],
            lambda env: env["ssm_y"],
            lambda env, out: env.__setitem__("x", env["x"] + out),
            shape=GemmShape(m=B, n=d, k=d_inner),
            reads=("ssm_y", "x"), writes=("x",)))

    _emit_final_logits(cfg, params, stages, m_rows=B)
    stages.append(_decode_finish(torch.stack, keys=("conv", "h")))
    return ProgramTemplate(stages=stages, batch=B, model_name=cfg.name)


# ---------------------------------------------------------------------------
# prefill programs — the prompt pass as first-class declared ops
# ---------------------------------------------------------------------------

def prefill_bucket(prompt_len: int, minimum: int = 8) -> int:
    """Power-of-two padding bucket for a prompt length. Padded tail rows
    are computed and discarded — causal masking keeps them out of every
    real row's softmax, and the epilogue copies only the real positions."""
    assert prompt_len >= 1, prompt_len
    return max(minimum, 1 << (prompt_len - 1).bit_length())


def _causal_prefill_attend(cfg: ModelConfig, Sp: int, q_flat, k_flat,
                           v_flat, positions, is_global: bool, out_dtype
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """One layer of causal prompt attention. Returns (attn_out [Sp, H·hd],
    k [1, Hkv, Sp, hd] rope'd, v [1, Hkv, Sp, hd] raw) — the k/v pair in
    decode-cache layout."""
    hd = cfg.resolved_head_dim
    q = q_flat.reshape(1, Sp, cfg.num_heads, hd)
    k = k_flat.reshape(1, Sp, cfg.num_kv_heads, hd)
    v = v_flat.reshape(1, Sp, cfg.num_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    G = cfg.num_heads // cfg.num_kv_heads
    qg = q.reshape(1, Sp, cfg.num_kv_heads, G, hd)
    scores = qk_scores(qg, k)
    scores = scores / math.sqrt(hd)
    idx = torch.arange(Sp, device=q.device)
    ok = idx[None, :] <= idx[:, None]
    if cfg.window_size > 0 and not is_global:
        ok = ok & (idx[None, :] > (idx[:, None] - cfg.window_size))
    scores = torch.where(ok[None, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhgst,bthd->bshgd", p, v.float())
    return (o.reshape(Sp, cfg.num_heads * hd).to(out_dtype),
            k.transpose(1, 2), v.transpose(1, 2))


def prefill_program_cache_key(model, params, seq_len: int, cache, *,
                              stacked: bool = True) -> Tuple:
    """Plan-cache key for a dense prefill template: (model identity, padded
    prompt bucket, dtype, cache geometry); params identity is guarded at
    the lookup site. The regime and depth are in the key: a stacked and a
    per-layer template of one model never alias."""
    kc = cache["layers"]["k"]
    return ("dense-prefill", model.cfg.name, id(model), seq_len,
            str(params["embed"].dtype), str(kc.dtype), tuple(kc.shape),
            ("stacked", bool(stacked), model.cfg.num_layers))


def build_dense_prefill_template(model, params, seq_len: int, *,
                                 stacked: bool = True) -> ProgramTemplate:
    """Compile the PROMPT pass of a dense GQA model into a ProgramTemplate.

    Every projection GEMM is declared with m = ``seq_len`` (the padded
    prefill bucket). Equivalent to ``Model.prefill``, last-position logits
    only. Per-request env entries (bound via ``bind``'s ``env_extra``):
    ``tokens`` (the prompt zero-padded to [1, seq_len]), ``real_len`` (the
    true prompt length S), ``slot`` (the reserved decode slot the epilogue
    writes, or None for a request that never decodes) and ``cache``.
    ``stacked=True`` (default) emits one layer body per homogeneous
    sub-stack; ``stacked=False`` the per-layer stages."""
    cfg: ModelConfig = model.cfg
    assert cfg.arch_type == "dense", cfg.arch_type
    Sp = seq_len
    stages: List[Stage] = []

    def glue(fn, reads=None, writes=None):
        stages.append(GlueStage(fn, reads=reads, writes=writes))

    def embed(env):
        x = params["embed"][env["tokens"]]            # [1, Sp, d]
        env["x"] = (x * _embed_scale(cfg, x))[0]
        env["positions"] = torch.arange(Sp, device=x.device)[None, :]

    glue(embed, reads=("tokens",), writes=("x", "positions"))

    if stacked:
        def read(env, lo, hi):
            return {"x": env["x"], "positions": env["positions"]}

        def stacked_attend_for(inp, is_global):
            # causal self-attention over the whole (padded) prompt
            positions = inp["positions"]

            def attend(i, q, k, v, dtype):
                attn_out, k_t, v_t = _causal_prefill_attend(
                    cfg, Sp, q, k, v, positions, is_global, dtype)
                return attn_out, k_t[0], v_t[0]

            return attend

        # a body is a function of x alone at a bucket (positions are
        # arange(Sp); real_len and slot are read after the bodies), so it
        # is keyed as a decode body is, with the bucket for the batch
        for lo, hi in partition_layers(cfg.global_layer_flags()):
            stages.append(_stacked_body_stage(
                cfg, params, lo, hi, m_rows=Sp, read=read,
                attend_for=stacked_attend_for, reads=("x", "positions"),
                graph_key=("prefill", cfg, Sp)))
    else:
        def attend_for(l, lp, is_global):
            # causal self-attention over the whole (padded) prompt: the
            # JAX package's ``prefill-attend`` glue jit, keyed (cfg, Sp,
            # is_global, out dtype), its arguments q / k / v and positions
            def bind(env):
                out_dtype = env["h"].dtype

                def attend(inp):
                    attn_out, k_t, v_t = _causal_prefill_attend(
                        cfg, Sp, inp["q"], inp["k"], inp["v"],
                        inp["positions"], is_global, out_dtype)
                    return {"attn_out": attn_out, "k": k_t, "v": v_t}

                key = ("prefill-attend", cfg, Sp, bool(is_global),
                       _dtype_name(out_dtype))
                return key, attend, {"q": env["wq"], "k": env["wk"],
                                     "v": env["wv"],
                                     "positions": env["positions"]}

            return GlueIO(bind, _write_attend)

        _emit_dense_body(cfg, params, stages, m_rows=Sp,
                         attend_for=attend_for,
                         attend_reads=("wq", "wk", "wv", "positions"))

    def final_norm(env):
        # only the last REAL position is unembedded
        last = env["x"][env["real_len"] - 1:env["real_len"]]
        env["hf"] = rmsnorm(last, params["final_norm"], cfg.norm_eps)

    glue(final_norm, reads=("x", "real_len"), writes=("hf",))
    _emit_unembed(cfg, params, stages, m_rows=1)

    def finish(env):
        """Epilogue: write the request's KV rows into its reserved slot —
        the S real positions (k rope'd, v raw), zero-padded to cache_len,
        and pos[slot] = S — as new cache tensors."""
        slot = env["slot"]
        if slot is None:
            return
        S = env["real_len"]
        cache = env["cache"]
        layers = cache["layers"]
        kc, vc = layers["k"], layers["v"]
        cache_len = int(kc.shape[3])
        pad = (0, 0, 0, cache_len - S)
        k_new = torch.cat(env["new_layers"]["k"], dim=0)[:, :, :S]
        v_new = torch.cat(env["new_layers"]["v"], dim=0)[:, :, :S]
        kc, vc = kc.clone(), vc.clone()
        kc[:, slot] = F.pad(k_new, pad).to(kc.dtype)
        vc[:, slot] = F.pad(v_new, pad).to(vc.dtype)
        pos = cache["pos"].clone()
        # a fill, not ``pos[slot] = S``: that copies a host scalar in, a
        # copy that waits for the card (the prompt pass just queued)
        pos.narrow(0, slot, 1).fill_(S)
        env["cache"] = {"pos": pos, "layers": {**layers, "k": kc, "v": vc}}

    glue(finish, reads=("cache", "new_layers", "real_len", "slot"),
         writes=("cache",))
    return ProgramTemplate(stages=stages, batch=Sp, model_name=cfg.name,
                           kind="prefill")


def build_dense_decode_program(model, params, tokens: torch.Tensor, cache,
                               stream_id: int, *, slo_s: float = float("inf"),
                               arrival_t: float = 0.0,
                               deadline_t: float = float("inf"),
                               req_deadlines: Tuple = ()) -> KernelProgram:
    """One-shot compile + bind (the uncached path). The serving engine
    instead caches the template and calls ``bind`` per step."""
    template = build_dense_decode_template(model, params,
                                           int(tokens.shape[0]))
    return template.bind(stream_id=stream_id, tokens=tokens, cache=cache,
                         slo_s=slo_s, arrival_t=arrival_t,
                         deadline_t=deadline_t, req_deadlines=req_deadlines)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StreamStat:
    """Streaming aggregate (count/sum/min/max) over one per-superkernel
    observable; ``+`` folds two aggregates."""

    count: int = 0
    total: float = 0.0
    min: float = math.inf
    max: float = -math.inf

    def add(self, x: float) -> None:
        self.count += 1
        self.total += x
        self.min = min(self.min, x)
        self.max = max(self.max, x)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def __add__(self, other: "StreamStat") -> "StreamStat":
        if not self.count:
            return dataclasses.replace(other)
        if not other.count:
            return dataclasses.replace(self)
        return StreamStat(self.count + other.count, self.total + other.total,
                          min(self.min, other.min), max(self.max, other.max))


@dataclasses.dataclass
class JitStats:
    superkernels: int = 0
    ops_executed: int = 0
    groups: StreamStat = dataclasses.field(default_factory=StreamStat)
    padding_waste: StreamStat = dataclasses.field(default_factory=StreamStat)
    modeled_time_s: float = 0.0
    modeled_serial_time_s: float = 0.0
    shared_dispatches: int = 0
    waits: int = 0                 # stagger (WAIT) decisions taken
    evictions: int = 0             # missed stragglers demoted from EDF
    mid_flight_admissions: int = 0  # programs joining live ops post-start
    # dispatched groups that packed a prefill op with another stream's op
    prefill_coalesced: int = 0
    # MoE / SSM decode steps admitted as KernelPrograms (the serving
    # engine counts one per program it admits for such a tenant)
    nondense_programs: int = 0
    # dispatched groups that packed an MoE expert GEMM (tag "expert_*", or
    # a body with expert operands: clustering.is_expert_op) with another
    # stream's op
    expert_coalesced: int = 0
    # plan-cache deltas accrued during this run (core/plancache.py)
    plan_cache: PlanCacheStats = dataclasses.field(
        default_factory=PlanCacheStats)
    block_plans: PlanCacheStats = dataclasses.field(
        default_factory=PlanCacheStats)
    # live-tuner cache deltas (``VLIWJit.tune_cache``): one access per
    # planned dispatch when live tuning is on (zeros otherwise), a miss
    # only on a group signature never seen before
    tune_cache: PlanCacheStats = dataclasses.field(
        default_factory=PlanCacheStats)
    # dispatch fast-path deltas (core/dispatch.py)
    dispatch: DispatchStats = dataclasses.field(default_factory=DispatchStats)
    # schedule-certifier counters (``ServingEngine(certify=True)``):
    # legality checks run and violations observed; a clean pass needs
    # checks > 0 as well as violations == 0
    hazard_checks: int = 0
    hazard_violations: int = 0
    # modelled cross-device collective seconds charged (the all-to-all of
    # MoE tenants whose experts span the mesh)
    collective_time_s: float = 0.0
    # dispatched groups that actually coalesced (>1 op)
    coalesced_groups: int = 0

    @property
    def mean_group(self) -> float:
        return self.groups.mean

    @property
    def modeled_speedup(self) -> float:
        return self.modeled_serial_time_s / self.modeled_time_s \
            if self.modeled_time_s else 1.0

    def merge(self, other: "JitStats") -> "JitStats":
        """Fold another run's counters into this one (in place)."""
        for f in dataclasses.fields(self):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))
        return self


@dataclasses.dataclass
class TickEvent:
    """Outcome of one scheduler decision on the session's virtual clock."""
    kind: str                      # "dispatch" | "wait" | "idle"
    t: float                       # virtual time after the event
    dt: float = 0.0                # modeled device seconds consumed
    completed: List[KernelProgram] = dataclasses.field(default_factory=list)


# a timed admission: (virtual arrival time, program or zero-arg factory)
Arrival = Tuple[float, Union[KernelProgram, Callable[[], KernelProgram]]]


class JitSession:
    """A live, admission-open run of the VLIW JIT on one device of the
    modelled mesh: the scheduler, live-op pool and stats persist across
    calls, and the caller admits programs between superkernel dispatches
    and advances the device's virtual clock one scheduler decision
    (``tick``) at a time."""

    def __init__(self, jit: "VLIWJit", record_trace: bool = False, *,
                 device: int = 0, cost: Optional[CostModel] = None,
                 trace: Optional[ScheduleTrace] = None):
        self.jit = jit
        self.stats = JitStats()
        # one session drives ONE device's timeline. Device 0 on the jit's
        # cost model is the single-device setup and reuses the jit's
        # coalescer; any other device plans with its own cost model and
        # keys the shared block-plan memo with its id
        self.device = device
        self.cost = cost if cost is not None else jit.cost
        if device == 0 and cost is None:
            coalescer = jit.coalescer
        else:
            # and its own tuner over its own cost model, sharing the jit's
            # tune cache (the device id is in every key)
            tuner = None if jit.tuner is None else \
                LiveTuner(self.cost, jit.tune_cache,
                          objective=jit.tune_objective, device_id=device)
            coalescer = Coalescer(self.cost, max_group=jit.max_group,
                                  memo=jit.block_plans, device_id=device,
                                  tuner=tuner)
        self.sched = OoOScheduler(self.cost, coalescer, jit.sched_cfg,
                                  device=device)
        # expert-parallel span per stream: a stream whose MoE experts span
        # more than one device pays the all-to-all on every expert trio
        self.stream_span: Dict[int, int] = {}
        # the certifier's audit log (None: record nothing). A mesh shares
        # one trace across its per-device sessions
        self.trace: Optional[ScheduleTrace] = trace if trace is not None \
            else (ScheduleTrace() if record_trace else None)
        # pending GEMM or layer body per program: op_id -> (program, stage)
        self.live: Dict[int, Tuple[KernelProgram,
                                   Union[GemmStage, StackedGemmStage]]] = {}
        self._done: List[KernelProgram] = []
        self._started = False          # True once the first tick has run
        # plan caches and the executor outlive sessions; snapshot their
        # counters so this session reports only its own delta
        self._plan_base = jit.plan_cache.stats.copy()
        self._block_base = jit.block_plans.stats.copy()
        self._tune_base = jit.tune_cache.stats.copy()
        self._dispatch_base = jit.executor.stats.copy()

    def _sync_cache_stats(self) -> None:
        """Bring ``stats``' delta of the shared caches since the session
        opened up to date (by its reader, when it reads them: not per
        tick)."""
        self.stats.plan_cache = self.jit.plan_cache.stats - self._plan_base
        self.stats.block_plans = self.jit.block_plans.stats - self._block_base
        self.stats.tune_cache = self.jit.tune_cache.stats - self._tune_base
        self.stats.dispatch = self.jit.executor.stats - self._dispatch_base

    @property
    def pending(self) -> int:
        return len(self.live)

    def set_next_arrival(self, t: float) -> None:
        """Tell the scheduler when the next admission is coming."""
        self.sched.next_arrival_t = t

    def set_stream_span(self, stream_id: int, span: int) -> None:
        """Declare a stream's expert-parallel device span (the placement
        policy's ``TenantPlacement.expert_span``). A span > 1 charges the
        all-to-all on every expert trio the stream declares from now on."""
        self.stream_span[stream_id] = span

    def admit(self, prog: KernelProgram) -> None:
        """Add a program to the live pool (legal at any point in time)."""
        if self.live and self._started:
            self.stats.mid_flight_admissions += 1
        prog.device = self.device     # placement binds at admission
        if self.trace is not None:
            self.trace.prog_admits.append(ProgramAdmit(
                prog_uid=prog.uid, stream=prog.stream_id, kind=prog.kind,
                req_ids=tuple(r for r, _ in prog.req_deadlines),
                kv_writes=tuple(prog.kv_writes), device=self.device))
        st = prog.advance_glue(self.jit.run_glue)
        if st is None:            # pure-glue program: completes immediately
            self._done.append(prog)
            return
        self._push_op(prog, st)

    def _expert_collective_s(self, stream_id: int, m: int, k: int,
                             layers: int = 1, dtype_bytes: int = 2) -> float:
        """All-to-all charge for one expert trio of a device-spanning MoE
        stream: dispatch scatters the [m, k] expert activations to the
        shards, combine gathers them back, 2·m·k bytes a layer. Charged
        once a trio (on its gate GEMM); local streams pay nothing."""
        span = self.stream_span.get(stream_id, 1)
        if span <= 1:
            return 0.0
        return self.cost.all_to_all_time(
            2.0 * layers * m * k * dtype_bytes, span)

    def _push_op(self, prog: KernelProgram, st: Stage) -> None:
        if isinstance(st, StackedGemmStage):
            self._push_stacked_op(prog, st)
            return
        a = st.input_fn(prog.env)
        w = st.weight_fn()
        op = make_op(prog.stream_id, op_aspect(int(a.shape[0]), self.jit.bm),
                     GemmShape(m=int(a.shape[0]), n=int(w.shape[1]),
                               k=int(w.shape[0])),
                     arrival_t=prog.arrival_t,
                     deadline_t=prog.effective_deadline,
                     seq_index=prog.pc, tag=st.tag,
                     model_id=st.weight_key[0] if st.weight_key else "",
                     op_kind=prog.kind)
        # operand bindings ride on the op (declarative dispatch payload)
        op.payload = (a, w, st.weight_key)
        op.prog_uid = prog.uid
        op.device = self.device
        if st.tag == "expert_gate":
            op.collective_s = self._expert_collective_s(
                prog.stream_id, op.shape.m, op.shape.k)
        op.req_deadlines = prog.req_deadlines
        if math.isfinite(op.deadline_t):
            # EDF anchor = deadline minus the program's remaining critical
            # path (and any collective), so upstream stages inherit the
            # urgency of the whole step
            op.latest_start_t = op.deadline_t \
                - prog.remaining_gemm_time(self.cost, prog.pc) \
                - op.collective_s
        self.live[op.op_id] = (prog, st)
        self.sched.push([op])

    def _push_stacked_op(self, prog: KernelProgram,
                         st: StackedGemmStage) -> None:
        """Declare one layer body as a single KernelOp. ``op.shape`` is the
        DOMINANT operand (largest weight volume) for EDF and aspect
        bookkeeping; the full per-operand signature rides on ``op.stack``
        and drives coalescing and the cost charge."""
        dom = max((od.shape for od in st.operands),
                  key=lambda s: s.layers * s.n * s.k)
        op = make_op(prog.stream_id, op_aspect(dom.m, self.jit.bm), dom,
                     arrival_t=prog.arrival_t,
                     deadline_t=prog.effective_deadline,
                     seq_index=prog.pc, tag=st.tag,
                     model_id=st.weight_key[0], op_kind=prog.kind)
        op.stack = tuple((od.tag, od.shape) for od in st.operands)
        # no activation binding: the operands are fetched at dispatch
        # (_run_stacked). The weight slot holds the operands' guard tensors
        # (the original stacked params) as the op's weight identity.
        op.payload = (None,
                      tuple(t for od in st.operands for t in od.guard),
                      st.weight_key)
        op.prog_uid = prog.uid
        op.device = self.device
        # expert-parallel collective: charged on the body's first
        # expert_gate operand, one dispatch + combine a layer of the trio
        for od in st.operands:
            if od.tag == "expert_gate":
                op.collective_s = self._expert_collective_s(
                    prog.stream_id, od.shape.m, od.shape.k,
                    layers=od.shape.layers,
                    dtype_bytes=od.shape.dtype_bytes)
                break
        op.req_deadlines = prog.req_deadlines
        if math.isfinite(op.deadline_t):
            op.latest_start_t = op.deadline_t \
                - prog.remaining_gemm_time(self.cost, prog.pc) \
                - op.collective_s
        self.live[op.op_id] = (prog, st)
        self.sched.push([op])

    def _op_record(self, op: KernelOp) -> OpRecord:
        """Snapshot one live op for the dispatch trace. Env writes come
        from the stage's declared ``writes``; an undeclared stage aliases
        everything (``("*",)``), qualified by the env's identity so two
        tenants' private envs never read as one resource."""
        prog, st = self.live[op.op_id]
        writes = getattr(st, "writes", None)
        return OpRecord(
            op_id=op.op_id, stream=op.stream_id, prog_uid=op.prog_uid,
            tag=op.tag, seq=op.seq_index, op_kind=op.op_kind,
            deadline_t=op.deadline_t, latest_start_t=op.latest_start_t,
            weight_key=op_weight_key(op), weight_id=op_weight_identity(op),
            kv_writes=tuple(prog.kv_writes),
            env_writes=tuple(writes) if writes is not None else ("*",),
            env_id=id(prog.env), device=op.device)

    def _run_stacked(self, ops, completed: List[KernelProgram],
                     block: Optional[BlockConfig] = None) -> None:
        """Dispatch a coalesced group of layer-body ops: fetch each op's
        stacked operands from the executor's persistent cache, then run the
        bodies back to back. The operands' cache accesses collapse into ONE
        hit or miss and one dispatch per op (a miss if any operand had to
        be packed), so ``weight_hits + weight_misses == dispatches`` holds
        across plain and stacked dispatch alike. ``block`` is the plan's
        live-tuned tile (None: the executor's default); the bodies'
        launches take its ``bm``."""
        ex = self.jit.executor
        for op in ops:
            prog, st = self.live.pop(op.op_id)
            h0, m0 = ex.stats.weight_hits, ex.stats.weight_misses
            padded = {}
            for od in st.operands:
                # params-free slot identity: a hot-swap (new params id in
                # the key) drops the superseded entry of the same slot
                group = (op.stream_id, od.weight_key[0]) \
                    + od.weight_key[2:]
                padded[od.tag] = ex.stacked_operand(
                    od.weight_key, od.shape.k, od.shape.n, od.shape.layers,
                    od.weight_fn, od.guard, group=group, device=op.device)
            missed = ex.stats.weight_misses > m0
            ex.stats.weight_hits, ex.stats.weight_misses = h0, m0
            if missed:
                ex.stats.weight_misses += 1
            else:
                ex.stats.weight_hits += 1
            ex.stats.dispatches += 1
            builds0 = build_count()
            # the body's device time goes on the dispatch's span while
            # tracing (core/telemetry.py)
            with telemetry.body(prog.kind, next(iter(padded.values()))):
                if self.jit.cuda_graphs:
                    # a replay of the body's CUDA graph (a capture at its
                    # key's first call); eager on the CPU
                    self.jit.graphs.run(st, prog.env, padded, ex, block)
                else:
                    st.run(prog.env, padded, ex, block)
            ex.stats.retraces += build_count() - builds0
            self._advance(prog, completed)

    def _advance(self, prog: KernelProgram,
                 completed: List[KernelProgram]) -> None:
        """Step past the stage just run: declare the program's next op, or
        complete it."""
        prog.pc += 1
        nxt = prog.advance_glue(self.jit.run_glue)
        if nxt is None:
            completed.append(prog)
        else:
            self._push_op(prog, nxt)

    def tick(self, now: float) -> TickEvent:
        """Execute one scheduler decision at virtual time ``now``: the
        decision and the dispatch are each a span while tracing."""
        completed, self._done = self._done, []
        if not self.live:
            return TickEvent("idle", now, completed=completed)
        self._started = True
        with telemetry.span("jit.decide"):
            decision = self.sched.decide(now)
        stats = self.stats
        stats.evictions = self.sched.evictions
        if decision.kind == "wait":
            stats.waits += 1
            if self.trace is not None:
                self.trace.waits.append(decision.wait_until)
            return TickEvent("wait", decision.wait_until, completed=completed)
        assert decision.kind == "dispatch" and decision.plan
        plan = decision.plan
        with telemetry.span("jit.dispatch") as sp:
            t = self._dispatch(plan, now, completed)
            if sp:
                sp.set(group=len(plan.ops))
        return TickEvent("dispatch", now + t, dt=t, completed=completed)

    def _dispatch(self, plan, now: float,
                  completed: List[KernelProgram]) -> float:
        """Run a planned group and account it; returns its modelled
        seconds."""
        # a group whose ops all carry ONE weight key loads the weights once
        shared = shared_weight_key(plan.ops) is not None
        stacked = plan.ops[0].stack is not None
        if self.trace is not None:
            # recorded BEFORE execution: a dispatch that raises still
            # leaves the offending group on the trace
            self.trace.dispatches.append(DispatchRecord(
                t=now, shared_operand=shared, device=self.device,
                ops=tuple(self._op_record(op) for op in plan.ops)))
        # one all-to-all covers the group (a per-layer exchange, not per
        # member): charge the max, as Coalescer.plan does for est_time_s
        coll = max((op.collective_s for op in plan.ops), default=0.0)
        # live tuning: the plan's block is the tile the tuner chose for
        # this group's signature, and it flows into the launches; off,
        # the executor keeps its default
        tuned_block = plan.block if self.jit.live_tune else None
        if stacked:
            # coalesce_key keeps stacked and plain ops in disjoint buckets;
            # the bodies run after the stats below (_run_stacked)
            assert all(op.stack is not None for op in plan.ops)
            serial_shapes = [s for op in plan.ops for _, s in op.stack]
            t = plan.est_time_s          # already includes the collective
        else:
            outs = self.jit.executor.execute(plan.ops,
                                             shared_operand=shared,
                                             device=self.device,
                                             block=tuned_block)
            serial_shapes = [o.shape for o in plan.ops]
            t = self.cost.coalesced_time(serial_shapes, plan.block,
                                         shared_operand=shared) + coll
        stats = self.stats
        stats.superkernels += 1
        stats.ops_executed += len(plan.ops)
        stats.groups.add(len(plan.ops))
        stats.padding_waste.add(plan.padding_waste)
        stats.shared_dispatches += int(shared)
        stats.collective_time_s += coll
        stats.coalesced_groups += int(len(plan.ops) > 1)
        if len({op.stream_id for op in plan.ops}) > 1:
            if any(op.op_kind == "prefill" for op in plan.ops):
                stats.prefill_coalesced += 1
            if any(is_expert_op(op) for op in plan.ops):
                stats.expert_coalesced += 1
        stats.modeled_time_s += t
        stats.modeled_serial_time_s += self.cost.time_multiplexed(
            serial_shapes, plan.block) + coll
        if stacked:
            self._run_stacked(plan.ops, completed, block=tuned_block)
        else:
            for op, out in zip(plan.ops, outs):
                prog, st = self.live.pop(op.op_id)
                st.output_fn(prog.env, out)
                self._advance(prog, completed)
        return t


class VLIWJit:
    """Run tenant KernelPrograms to completion with OoO coalescing."""

    def __init__(self, cost: Optional[CostModel] = None,
                 sched_cfg: SchedulerConfig = SchedulerConfig(),
                 max_group: int = 16, bm: int = 8,
                 plan_capacity: int = 128,
                 weight_capacity: Optional[int] = None,
                 weight_budget_bytes: Optional[int] = 1 << 30,
                 live_tune: bool = False,
                 tune_objective: str = "collaborative",
                 cuda_graphs: bool = True):
        # the modelled device defaults to the H100 (spec-sheet values;
        # every time the cost model derives is modelled, not measured)
        self.cost = cost or CostModel(H100)
        # persistent plan caches: program templates and superkernel block
        # plans; plan_capacity=0 disables both
        self.plan_cache = PlanCache(plan_capacity)
        self.block_plans = PlanCache(plan_capacity * 4)
        self.max_group = max_group
        # live collaborative autotuning (core/autotuner.LiveTuner): when on,
        # every coalescer consults the tuner per plan and the tuned block
        # reaches the dispatch (its bm the kernel's launch; bn / bk stay
        # modelled, see SuperkernelExecutor.execute). Tune results live in
        # their own device-keyed cache beside the block plans; it exists
        # with tuning off too, its counters then stay zero.
        # tune_objective="greedy" is the paper's Table 1 ablation.
        self.tune_cache = PlanCache(plan_capacity * 4)
        self.live_tune = live_tune
        self.tune_objective = tune_objective
        self.tuner = LiveTuner(self.cost, self.tune_cache,
                               objective=tune_objective) if live_tune \
            else None
        self.coalescer = Coalescer(self.cost, max_group=max_group,
                                   memo=self.block_plans, tuner=self.tuner)
        self.sched_cfg = sched_cfg
        self.bm = bm
        # packed weight operands cached across sessions; entries are full
        # padded weight copies, so weight_budget_bytes (LRU over bytes;
        # None = unbounded) is what bounds device memory
        wcap = 2 * plan_capacity if weight_capacity is None else \
            weight_capacity
        self.weight_cache = PlanCache(wcap,
                                      byte_capacity=weight_budget_bytes)
        # the CUDA graphs (core/graphs.py) of the stacked bodies (decode
        # and prefill), the per-layer glue, the serving engine's
        # monolithic model calls and the executor's dispatch bodies: the
        # counterparts of the JAX package's jitted layer scans, glue and
        # dispatch bodies, which it always compiles. On by default; False
        # runs every one of them eagerly (the eager twin of the graphed
        # run). The CPU never captures. A graph reads packed weights by raw
        # pointer, so every pack the weight cache drops takes the graphs
        # that read it along. The executor owns this cache and the flag
        # (``graphs``, ``cuda_graphs``).
        graphs = GraphCache(resident=self.weight_cache.holds)
        self.weight_cache.on_drop.append(graphs.drop_operand)
        self.executor = SuperkernelExecutor(self.weight_cache, bm=bm,
                                            graphs=graphs,
                                            cuda_graphs=cuda_graphs)

    @property
    def graphs(self) -> GraphCache:
        """The JIT's CUDA graphs (one cache, the executor's)."""
        return self.executor.graphs

    @graphs.setter
    def graphs(self, cache: GraphCache) -> None:
        self.executor.graphs = cache

    @property
    def cuda_graphs(self) -> bool:
        """Whether the JIT's compiled parts run as CUDA graphs (one flag,
        the executor's)."""
        return self.executor.cuda_graphs

    @cuda_graphs.setter
    def cuda_graphs(self, on: bool) -> None:
        self.executor.cuda_graphs = on

    def run_glue(self, io: GlueIO, env: Dict[str, Any]) -> None:
        """Run one per-layer glue stage: a replay of its key's CUDA graph
        (``cuda_graphs``), else eagerly."""
        if self.cuda_graphs:
            self.graphs.glue(io, env, self.executor.stats)
        else:
            io.run(env)

    def session(self, record_trace: bool = False, *, device: int = 0,
                cost: Optional[CostModel] = None,
                trace: Optional[ScheduleTrace] = None) -> JitSession:
        """Open an admission-open event-loop session (engine entry point).
        ``record_trace=True`` keeps a ``ScheduleTrace`` for the schedule
        certifier; a mesh opens one session per device (``device``,
        ``cost``), all sharing this JIT's caches and optionally one
        ``trace``."""
        return JitSession(self, record_trace=record_trace, device=device,
                          cost=cost, trace=trace)

    def run(self, programs: Sequence[KernelProgram],
            arrivals: Optional[Sequence[Arrival]] = None,
            start_t: float = 0.0) -> JitStats:
        """Drive a session to completion on a virtual clock: ``programs``
        are admitted at ``start_t``; each ``(t, program)`` in ``arrivals``
        is admitted mid-flight once the clock reaches ``t``."""
        session = self.session()
        for prog in programs:
            session.admit(prog)
        queue = sorted(arrivals or (), key=lambda e: e[0])
        qi = 0
        now = start_t
        while True:
            while qi < len(queue) and queue[qi][0] <= now:
                entry = queue[qi][1]
                session.admit(entry() if callable(entry) else entry)
                qi += 1
            session.set_next_arrival(queue[qi][0] if qi < len(queue)
                                     else math.inf)
            ev = session.tick(now)
            if ev.kind == "idle":
                if qi < len(queue):
                    now = queue[qi][0]
                    continue
                break
            now = max(now, ev.t)
        session._sync_cache_stats()
        return session.stats
