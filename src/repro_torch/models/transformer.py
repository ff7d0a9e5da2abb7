"""The decoder stacks of the dense, MoE and SSM families: prefill and
single-token decode over stacked per-layer params (a loop over the leading
layer axis).

An MoE layer is GQA attention followed by the MoE FFN (``models/moe.py``)
in place of the gated MLP; an SSM layer is a Mamba-2 block
(``models/ssm.py``) on the pre-norm input and no FFN, and its cache is the
conv window and the SSD state (``conv`` / ``h``) instead of k / v.

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
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
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


def _ffn(p: Params, h2: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The layer's FFN on the post-norm input [B, S, d]: the MoE FFN over
    the B·S tokens as one group, or the gated MLP."""
    if cfg.has_moe:
        B, S, d = h2.shape
        y, _aux = moe_lib.moe_ffn(p["moe"], h2.reshape(B * S, d), cfg.moe)
        return y.reshape(B, S, d)
    return mlp(p["mlp"], h2)


def stack_prefill(stacked: Params, x: torch.Tensor, cfg: ModelConfig,
                  flags: Sequence[bool]) -> Tuple[torch.Tensor, Cache]:
    """Full forward emitting the per-layer decode cache: [L, B, Hkv, S, hd]
    k / v, or the SSM's conv window and state."""
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    out: Dict[str, list] = {}
    for l, is_global in enumerate(flags):
        p = _layer(stacked, l)
        h = rmsnorm(x, p["ln1"], cfg.norm_eps)
        if cfg.arch_type == "ssm":
            y, st = ssm_lib.ssd_chunked(p["mamba"], h, cfg.ssm,
                                        return_state=True)
            for k in ("conv", "h"):
                out.setdefault(k, []).append(st[k])
            x = x + y
            continue
        k, v = _project_kv(p, h, cfg, positions)
        out.setdefault("k", []).append(k)
        out.setdefault("v", []).append(v)
        x = x + attn.attention_full(
            p["attn"], h, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
            rope_theta=cfg.rope_theta, is_global=is_global,
            window=cfg.window_size)
        h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = x + _ffn(p, h2, cfg)
    return x, {k: torch.stack(v) for k, v in out.items()}


def stack_decode(stacked: Params, x: torch.Tensor, cache: Cache,
                 pos: torch.Tensor, cfg: ModelConfig,
                 flags: Sequence[bool]) -> Tuple[torch.Tensor, Cache]:
    """One-token decode through all layers; returns the new layer cache
    (new tensors, in the input cache's dtypes — the input cache is left as
    it was)."""
    out: Dict[str, list] = {k: [] for k in cache}
    for l, is_global in enumerate(flags):
        p = _layer(stacked, l)
        h = rmsnorm(x, p["ln1"], cfg.norm_eps)
        if cfg.arch_type == "ssm":
            y, st = ssm_lib.ssd_decode_step(
                p["mamba"], h, {"conv": cache["conv"][l],
                                "h": cache["h"][l]}, cfg.ssm)
            new = st
            x = x + y
        else:
            a, nk, nv = attn.attention_decode(
                p["attn"], h, cache["k"][l], cache["v"][l], pos,
                num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                is_global=is_global, window=cfg.window_size)
            new = {"k": nk, "v": nv}
            x = x + a
            h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
            x = x + _ffn(p, h2, cfg)
        for k in out:
            out[k].append(new[k].to(cache[k].dtype))
    return x, {k: torch.stack(v) for k, v in out.items()}
