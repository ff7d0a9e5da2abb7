"""Base configuration dataclasses for the repro framework.

Every assigned architecture is expressed as a ``ModelConfig``. The config is a
plain frozen dataclass (hashable, usable as a jit static argument) describing
the *transformer backbone* — modality frontends (ViT for VLM, conv/mel for
audio) are stubs per the assignment: ``input_specs()`` provides precomputed
patch/frame embeddings of the right shape.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings for MoE layers."""

    num_experts: int
    top_k: int
    # capacity factor used when dispatching tokens to experts (train/prefill).
    capacity_factor: float = 1.25
    # weight of the auxiliary load-balancing loss.
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD — state space duality, arXiv:2405.21060) settings."""

    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk_size: int = 64
    d_conv: int = 4  # depthwise conv width in the mamba block

    def num_heads(self, d_model: int) -> int:
        return (self.expand * d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description for one assigned model.

    ``arch_type`` selects the block family:
      dense  — pre-norm decoder-only transformer (GQA/MQA attention)
      moe    — dense attention + MoE FFN every layer
      ssm    — attention-free Mamba-2 (SSD) stack
      hybrid — Hymba-style parallel attention + SSM heads in each layer
      vlm    — dense LLM backbone consuming stubbed patch embeddings
      audio  — Whisper-style encoder/decoder; conv/mel frontend stubbed
    """

    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    # --- attention locality -------------------------------------------------
    # window size for sliding-window/local layers (0 => all layers global).
    window_size: int = 0
    # pattern period P with one global layer per period (e.g. gemma3 is 6 with
    # 5 local : 1 global). 0 => all layers global.
    global_every: int = 0
    # --- optional sub-configs ------------------------------------------------
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # --- audio/vlm frontend stubs -------------------------------------------
    num_encoder_layers: int = 0           # audio (whisper) encoder depth
    encoder_seq_len: int = 0              # frames (audio) per the model card
    num_patch_tokens: int = 0             # vlm: patch embeddings per request
    # --- misc ----------------------------------------------------------------
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    source: str = ""                      # citation from the assignment table

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads == 0:  # attention-free
            return 0
        return self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded so the unembedding shards evenly over 16-way TP."""
        return _round_up(self.vocab_size, 256)

    @property
    def is_attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def is_encdec(self) -> bool:
        return self.arch_type == "audio"

    @property
    def has_moe(self) -> bool:
        return self.moe is not None

    @property
    def has_ssm(self) -> bool:
        return self.ssm is not None

    def layer_is_global(self, layer_idx: int) -> bool:
        """True if layer uses full (global) attention.

        With ``global_every == P``, the last layer of every period of P is
        global (gemma3: layers 5, 11, 17, 23 of 26; llama4: every 4th).
        """
        if self.window_size == 0 or self.global_every == 0:
            return True
        return (layer_idx % self.global_every) == (self.global_every - 1)

    def global_layer_flags(self) -> Tuple[bool, ...]:
        return tuple(self.layer_is_global(i) for i in range(self.num_layers))

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytical parameter count (embeddings included once if tied)."""
        d, dff, L = self.d_model, self.d_ff, self.num_layers
        hd = self.resolved_head_dim
        if self.arch_type == "ssm":
            s = self.ssm or SSMConfig()
            d_inner = s.expand * d
            nheads = s.num_heads(d)
            # in_proj: d -> (2*d_inner + 2*n_groups*d_state + nheads); use
            # n_groups = 1 for simplicity.
            in_proj = d * (2 * d_inner + 2 * s.d_state + nheads)
            out_proj = d_inner * d
            conv = s.d_conv * (d_inner + 2 * s.d_state)
            per_layer = in_proj + out_proj + conv + 2 * d
            body = L * per_layer
        else:
            q = d * (self.num_heads * hd)
            kv = 2 * d * (self.num_kv_heads * hd)
            o = (self.num_heads * hd) * d
            attn = q + kv + o
            if self.has_moe:
                ffn = self.moe.num_experts * 3 * d * dff + d * self.moe.num_experts
            else:
                ffn = 3 * d * dff  # gate/up/down (SwiGLU)
            per_layer = attn + ffn + 2 * d
            if self.arch_type == "hybrid":
                s = self.ssm or SSMConfig(d_state=16)
                d_inner = s.expand * d
                nheads = s.num_heads(d)
                per_layer += d * (2 * d_inner + 2 * s.d_state + nheads) + d_inner * d
            body = L * per_layer
            if self.is_encdec:
                enc_per_layer = attn + 3 * d * dff + 2 * d
                cross = attn
                body += self.num_encoder_layers * enc_per_layer + L * cross
        emb = self.padded_vocab * d
        if not self.tie_embeddings:
            emb *= 2
        return body + emb

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of num_experts FFNs)."""
        if not self.has_moe:
            return self.param_count()
        d, dff, L = self.d_model, self.d_ff, self.num_layers
        hd = self.resolved_head_dim
        attn = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd) + (
            self.num_heads * hd
        ) * d
        ffn_active = self.moe.top_k * 3 * d * dff + d * self.moe.num_experts
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        return L * (attn + ffn_active + 2 * d) + emb


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One assigned (seq_len, global_batch, kind) workload shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
