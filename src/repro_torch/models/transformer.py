"""The dense decoder stack: prefill and single-token decode over stacked
per-layer params (a loop over the leading layer axis).

The JAX package scans over layers and pins activations with
``distributed.hints.constrain``; neither has a counterpart needed on one
device, so the loop is plain Python and the stacked [L, ...] layout of the
params and of the cache is kept.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import Params, apply_rope, mlp, rmsnorm

Cache = Dict[str, Any]


def _layer(stacked: Params, l: int) -> Params:
    """Layer ``l``'s params as views into the stacked tree."""
    return {k: (_layer(v, l) if isinstance(v, dict) else v[l])
            for k, v in stacked.items()}


def _project_kv(p: Params, h: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    hd = cfg.resolved_head_dim
    B, S = h.shape[0], h.shape[1]
    k = (h @ p["attn"]["wk"]).reshape(B, S, cfg.num_kv_heads, hd)
    v = (h @ p["attn"]["wv"]).reshape(B, S, cfg.num_kv_heads, hd)
    k = apply_rope(k, positions, cfg.rope_theta)
    return k.transpose(1, 2), v.transpose(1, 2)             # [B,Hkv,S,hd]


def stack_prefill(stacked: Params, x: torch.Tensor, cfg: ModelConfig,
                  flags: Sequence[bool]) -> Tuple[torch.Tensor, Cache]:
    """Full forward emitting the per-layer decode cache ([L, B, Hkv, S, hd])."""
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    ks, vs = [], []
    for l, is_global in enumerate(flags):
        p = _layer(stacked, l)
        h = rmsnorm(x, p["ln1"], cfg.norm_eps)
        k, v = _project_kv(p, h, cfg, positions)
        ks.append(k)
        vs.append(v)
        x = x + attn.attention_full(
            p["attn"], h, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
            rope_theta=cfg.rope_theta, is_global=is_global,
            window=cfg.window_size)
        h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = x + mlp(p["mlp"], h2)
    return x, {"k": torch.stack(ks), "v": torch.stack(vs)}


def stack_decode(stacked: Params, x: torch.Tensor, cache: Cache,
                 pos: torch.Tensor, cfg: ModelConfig,
                 flags: Sequence[bool]) -> Tuple[torch.Tensor, Cache]:
    """One-token decode through all layers; returns the new layer cache
    (new tensors — the input cache is left as it was)."""
    ks, vs = [], []
    for l, is_global in enumerate(flags):
        p = _layer(stacked, l)
        h = rmsnorm(x, p["ln1"], cfg.norm_eps)
        a, nk, nv = attn.attention_decode(
            p["attn"], h, cache["k"][l], cache["v"][l], pos,
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
            is_global=is_global, window=cfg.window_size)
        ks.append(nk)
        vs.append(nv)
        x = x + a
        h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = x + mlp(p["mlp"], h2)
    return x, {"k": torch.stack(ks), "v": torch.stack(vs)}
