"""Declarative kernel dispatch IR (paper §5.1).

Instead of "early-binding, context-free" launches, tenants declare WHAT to
compute — a ``KernelOp`` (operator + problem dims + stream + deadline) — and
the JIT owns HOW: binding, packing, ordering. A stream of ``KernelOp``s is
the analogue of a VLIW instruction stream; ops from different streams are
mutually independent by construction (paper §1, reason (b) VLIW fits).

``gemm_population(config, ...)`` enumerates the GEMM problems one
architecture contributes per step — the population clustered in Fig. 7.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.costmodel import GemmShape


@dataclasses.dataclass
class KernelOp:
    """One declared unit of work in a tenant's instruction stream.

    ``kind`` describes the problem's aspect (a tall "gemm" vs a skinny
    "gemv") while ``op_kind`` names the serving phase that declared it
    ("decode" step vs "prefill" prompt pass). Neither partitions the
    coalescing space: the coalesced kernel concatenates problems along m,
    so a 256-row prefill GEMM and a 4-row decode GEMV with the same (n, k)
    pack into one superkernel (clustering.group_ops_exact) — that cross-
    phase packing is the paper's spatial-sharing win applied to prompts.
    """

    op_id: int
    stream_id: int
    kind: str                  # "gemm" | "gemv" | "attn" | "other"
    shape: GemmShape
    arrival_t: float = 0.0
    deadline_t: float = float("inf")
    # intra-stream program order: op i must not run before op i-1 of the same
    # stream has completed (data dependence through the residual stream).
    seq_index: int = 0
    tag: str = ""              # e.g. "qkv_proj", "ffn_up", "expert_gemm"
    model_id: str = ""
    # EDF bookkeeping: the latest virtual time this op can start and still
    # meet its request deadline given the modeled critical path behind it
    # (set by OoOScheduler.annotate_stream / push, or by the JIT from the
    # program's remaining-GEMM suffix).
    latest_start_t: float = float("inf")
    # operand bindings for the real execution path (core/jit.py attaches
    # (activation, weight, weight_key) at admission time); excluded from
    # repr/eq — it carries whole tensors
    payload: Optional[Tuple] = dataclasses.field(default=None, repr=False,
                                                 compare=False)
    # per-request identity plumbed from the serving engine through the
    # KernelProgram: (req_id, final deadline) for every request batched
    # into the step this op belongs to. The scheduler uses it to account
    # SLO demotions exactly once per missed request (even one hidden
    # behind a healthy batchmate's anchor deadline); empty for raw op
    # streams, which fall back to (stream, deadline) accounting.
    req_deadlines: Tuple = dataclasses.field(default=(), compare=False)
    # which serving phase declared this op: "decode" (one token against a
    # cache, m = batch) or "prefill" (whole prompt, m = padded prompt
    # length). Purely descriptive for scheduling stats — coalescing
    # eligibility is (n, k, dtype) only.
    op_kind: str = "decode"
    # layer-stacked op (core/jit.py StackedGemmStage): the ordered
    # (operand tag, per-layer GemmShape-with-layers) pairs of ONE scanned
    # layer body covering a homogeneous sub-stack of layers. None for
    # ordinary single-GEMM ops. ``shape`` then holds the DOMINANT operand's
    # shape (for EDF/aspect bookkeeping); coalescing uses the full stack
    # signature (clustering.coalesce_key).
    stack: Optional[Tuple] = dataclasses.field(default=None, repr=False,
                                               compare=False)
    # identity of the KernelProgram INSTANCE that emitted this op (set by
    # JitSession._push_op from KernelProgram.uid; 0 for raw op streams).
    # seq_index alone cannot express program order across a stream's
    # successive step programs — the schedule certifier
    # (analysis/certify.py) needs (prog_uid, seq) to verify
    # that ops of one program ran in order AND that two programs of one
    # stream never interleaved.
    prog_uid: int = dataclasses.field(default=0, compare=False)
    # placement: which modeled device of the mesh this op is assigned to.
    # Bound at admission (distributed/placement.py via JitSession.device)
    # and immutable afterwards — ops never coalesce across devices
    # (clustering.coalesce_key includes it) and the schedule certifier
    # rejects a dispatch on any other device (PlacementHazard).
    device: int = 0
    # modeled cross-device collective charge attached to this op (seconds):
    # MoE expert dispatch/combine all-to-all for tenants whose expert dim
    # spans devices, TP psum all-reduce when enabled. Charged against EDF
    # slack (latest_start_t) and added to the group's plan estimate — it is
    # NOT part of the memoized pure-GEMM block-plan time.
    collective_s: float = dataclasses.field(default=0.0, compare=False)

    @property
    def slack(self) -> float:
        return self.deadline_t - self.arrival_t


# Aspect boundary: a problem whose activation has at most this many rows is
# a skinny "gemv" (one m-tile of the bm=8 decode superkernel), anything
# taller is a "gemm". This is THE single source of truth — the JIT derives
# the boundary from its configured m-tile (``VLIWJit.bm``) and raw op
# streams fall back to this default; nothing else may hard-code the 8.
GEMV_MAX_ROWS = 8


def op_aspect(m: int, max_gemv_rows: int = GEMV_MAX_ROWS) -> str:
    """Classify a problem's aspect ("gemv" vs "gemm") by its row count.

    ``max_gemv_rows`` is the caller's m-tile: the JIT passes its ``bm`` so
    the classification always matches how the superkernel will actually
    tile the problem."""
    return "gemv" if m <= max_gemv_rows else "gemm"


_OP_COUNTER = itertools.count()


def make_op(stream_id: int, kind: str, shape: GemmShape, *, arrival_t=0.0,
            deadline_t=float("inf"), seq_index=0, tag="", model_id="",
            op_kind="decode") -> KernelOp:
    return KernelOp(next(_OP_COUNTER), stream_id, kind, shape, arrival_t,
                    deadline_t, seq_index, tag, model_id,
                    op_kind=op_kind)


# ---------------------------------------------------------------------------
# GEMM population extraction (Fig. 7)
# ---------------------------------------------------------------------------

def gemm_population(cfg: ModelConfig, batch: int, mode: str = "decode"
                    ) -> List[Tuple[str, GemmShape]]:
    """The per-step GEMM problems of one architecture.

    mode="decode": m = batch (token-parallel GEMV-like problems).
    mode="prefill": m = batch * seq would be supplied by caller via ``batch``.
    Returns (tag, GemmShape) pairs, one entry per layer occurrence collapsed
    to a single representative (the population repeats ``num_layers`` times).
    """
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    out: List[Tuple[str, GemmShape]] = []
    m = batch

    def g(tag: str, n: int, k: int):
        out.append((tag, GemmShape(m=m, n=n, k=k)))

    if cfg.arch_type == "ssm":
        s = cfg.ssm
        d_inner = s.expand * d
        g("ssm_in_proj", 2 * d_inner + 2 * s.d_state + s.num_heads(d), d)
        g("ssm_out_proj", d, d_inner)
    else:
        g("attn_q", cfg.num_heads * hd, d)
        g("attn_kv", 2 * cfg.num_kv_heads * hd, d)
        g("attn_o", d, cfg.num_heads * hd)
        if cfg.has_moe:
            # per-expert problems: tokens split across experts
            per_expert_m = max(1, (m * cfg.moe.top_k) // cfg.moe.num_experts)
            for tag, n, k in [("expert_gate", cfg.d_ff, d),
                              ("expert_up", cfg.d_ff, d),
                              ("expert_down", d, cfg.d_ff)]:
                out.append((tag, GemmShape(m=per_expert_m, n=n, k=k)))
            g("router", cfg.moe.num_experts, d)
        elif cfg.arch_type == "hybrid":
            s = cfg.ssm
            d_inner = s.expand * d
            g("ssm_in_proj", 2 * d_inner + 2 * s.d_state + s.num_heads(d), d)
            g("ssm_out_proj", d, d_inner)
            g("ffn_gate", cfg.d_ff, d)
            g("ffn_up", cfg.d_ff, d)
            g("ffn_down", d, cfg.d_ff)
        else:
            g("ffn_gate", cfg.d_ff, d)
            g("ffn_up", cfg.d_ff, d)
            g("ffn_down", d, cfg.d_ff)
    g("unembed", cfg.padded_vocab, d)
    return out


def stream_program(cfg: ModelConfig, stream_id: int, batch: int, *,
                   arrival_t: float = 0.0, slo_s: float = float("inf"),
                   mode: str = "decode") -> List[KernelOp]:
    """Expand one request into its full per-layer op stream (program order)."""
    ops: List[KernelOp] = []
    seq = 0
    layer_ops = gemm_population(cfg, batch, mode)
    body = [t for t in layer_ops if t[0] != "unembed"]
    for _layer in range(cfg.num_layers):
        for tag, shape in body:
            kind = op_aspect(shape.m)
            ops.append(make_op(stream_id, kind, shape, arrival_t=arrival_t,
                               deadline_t=arrival_t + slo_s, seq_index=seq,
                               tag=tag, model_id=cfg.name))
            seq += 1
    tag, shape = layer_ops[-1]
    ops.append(make_op(stream_id, "gemm", shape, arrival_t=arrival_t,
                       deadline_t=arrival_t + slo_s, seq_index=seq, tag=tag,
                       model_id=cfg.name))
    return ops


def zoo_population(configs: Sequence[ModelConfig], batch: int = 1
                   ) -> List[Tuple[str, str, GemmShape]]:
    """(arch, tag, shape) for the whole zoo — the Fig. 7 scatter."""
    rows = []
    for cfg in configs:
        for tag, shape in gemm_population(cfg, batch):
            rows.append((cfg.name, tag, shape))
    return rows
