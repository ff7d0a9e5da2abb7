"""Shared building blocks (plain PyTorch functions on tensors).

Conventions, as in the JAX package's ``models/layers.py``:
  * params are plain dicts of tensors;
  * per-layer params are STACKED on a leading layer axis ([L, ...]);
  * matmuls run in the param dtype (bf16 by default), reductions (norms,
    softmax) in fp32.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# initializers (on the tensor's device, from an explicit torch.Generator)
# ---------------------------------------------------------------------------

def dense_init_(out: torch.Tensor, generator: torch.Generator,
                scale: float = 1.0) -> torch.Tensor:
    """Fill ``out`` with truncated-normal fan-in init (stddev = scale /
    sqrt(fan_in), cut at ±2 stddev), drawn in fp32 one [k, n] matrix at a
    time so a stacked [L, ...] (or [L, E, ...]) weight never needs an fp32
    copy of itself."""
    if out.is_meta:                  # shapes only: nothing to draw
        return out
    fan_in = out.shape[-2] if out.dim() >= 2 else out.shape[-1]
    std = scale / math.sqrt(fan_in)
    slices = out.view(-1, *out.shape[-2:]) if out.dim() >= 3 else out[None]
    for s in slices:
        tmp = torch.empty(s.shape, dtype=torch.float32, device=s.device)
        torch.nn.init.trunc_normal_(tmp, std=std, a=-2.0 * std, b=2.0 * std,
                                    generator=generator)
        s.copy_(tmp)
    return out


def embed_init_(out: torch.Tensor, generator: torch.Generator
                ) -> torch.Tensor:
    if out.is_meta:
        return out
    tmp = torch.randn(out.shape, dtype=torch.float32, device=out.device,
                      generator=generator)
    return out.copy_(tmp * 0.02)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """fp32 RMS norm with the gemma ``(1 + gamma)`` scale convention."""
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return ((xf * scale) * (1.0 + gamma.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

# Host-precomputed rope cos/sin tables, one per (head_dim, theta), built
# exactly as the JAX package builds them (float64 numpy, cast to float32),
# so both packages rotate by the same bits. 8192 positions bounds every
# cache/prefill geometry served; an index past it raises (keep
# cache_len <= ROPE_TABLE_POSITIONS).
ROPE_TABLE_POSITIONS = 8192
_ROPE_TRIG: Dict[Any, Any] = {}
_ROPE_DEVICE: Dict[Any, Any] = {}


def _rope_trig_tables(head_dim: int, theta: float):
    key = (head_dim, float(theta))
    tab = _ROPE_TRIG.get(key)
    if tab is None:
        half = head_dim // 2
        freqs = 1.0 / (theta ** (np.arange(half, dtype=np.float64) / half))
        ang = np.arange(ROPE_TABLE_POSITIONS,
                        dtype=np.float64)[:, None] * freqs
        tab = (np.cos(ang).astype(np.float32),
               np.sin(ang).astype(np.float32))
        _ROPE_TRIG[key] = tab
    return tab


def _rope_tables_on(head_dim: int, theta: float, device: torch.device):
    key = (head_dim, float(theta), str(device))
    tab = _ROPE_DEVICE.get(key)
    if tab is None:
        cos_t, sin_t = _rope_trig_tables(head_dim, theta)
        tab = (torch.from_numpy(cos_t).to(device),
               torch.from_numpy(sin_t).to(device))
        _ROPE_DEVICE[key] = tab
    return tab


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: broadcastable to [..., seq]."""
    cos_t, sin_t = _rope_tables_on(int(x.shape[-1]), theta, x.device)
    idx = positions.long()
    cos = cos_t[idx][..., None, :]                # [..., seq, 1, half]
    sin = sin_t[idx][..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq_len: int, d_model: int,
                         device: Optional[torch.device] = None
                         ) -> torch.Tensor:
    """Whisper-style fixed sinusoidal position embeddings [seq, d_model]
    (fp32), computed as the JAX package computes them."""
    half = d_model // 2
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(half, dtype=torch.float32, device=device)[None, :]
    inv = torch.exp(-math.log(10000.0) * dim / max(half - 1, 1))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------

def silu_mul(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up — the gated-FFN activation."""
    return F.silu(gate) * up


def mlp(params: Params, x: torch.Tensor,
        d_ff: Optional[int] = None) -> torch.Tensor:
    """The gated MLP. Where ``w_gate`` holds this rank's "model" block of
    ``d_ff`` (``sharding.gather_at_use`` keeps it), the Megatron pair:
    ``copy_to_model`` at the column-parallel input, the rank's d_ff block
    of w_gate / w_up / w_down, ``reduce_from_model`` of the row-parallel
    output. A whole weight (no hint, or d_ff replicated by a ``_fits``
    fallback) is the plain MLP, with no collective."""
    from repro_torch.distributed.sharding import (copy_to_model, model_block,
                                                  reduce_from_model)
    ax, _ = model_block(params["w_gate"], -1, d_ff)
    if ax is not None:
        x = copy_to_model(x, ax)
    gate = x @ params["w_gate"]
    up = x @ params["w_up"]
    y = silu_mul(gate, up) @ params["w_down"]
    return y if ax is None else reduce_from_model(y, ax)
