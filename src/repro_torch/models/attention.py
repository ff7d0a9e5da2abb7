"""Grouped-query attention (GQA/MQA) with optional sliding-window locality.

Three execution modes, as in the JAX package's ``models/attention.py``:
  * full   — prompt prefill self-attention over the whole sequence,
    causal (decoders) or bidirectional (the whisper encoder), optional
    sliding window, rope optional (whisper has absolute positions);
  * decode — one new token per row against a slotted KV cache with per-row
    positions, returning the updated cache (functionally: a new tensor, the
    input cache is left as it was). With ``k_scale`` / ``v_scale`` the cache
    is int8 (``models/kvquant.py``): the new token is quantized on write
    and the cache dequantized on read into the compute dtype;
  * cross  — encoder-decoder cross attention (whisper), bidirectional over
    a fixed memory whose K/V ``project_memory_kv`` makes once.

A local (windowed) layer attends to ``pos - window < col <= pos``. The JAX
package reads only that band on long sequences; here the same set is
selected by a mask over the whole row, which gives the same softmax.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.models.kvquant import dequantize, quantize
from repro_torch.models.layers import Params, apply_rope

NEG_INF = -2.0e38


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n, hd))


def locality_mask(rows: torch.Tensor, cols: torch.Tensor, is_global: bool,
                  window: int, causal: bool = True) -> torch.Tensor:
    """Boolean mask [S, T] (True = attendable): causal or bidirectional,
    banded to ``window`` on local layers."""
    if causal:
        ok = cols[None, :] <= rows[:, None]
    else:
        ok = torch.ones((rows.shape[0], cols.shape[0]), dtype=torch.bool,
                        device=rows.device)
    if window > 0 and not is_global:
        ok = ok & (cols[None, :] > rows[:, None] - window)
    return ok


def attention_full(params: Params, x: torch.Tensor, *, num_heads: int,
                   num_kv_heads: int, head_dim: int, rope_theta: float,
                   is_global: bool = True, window: int = 0,
                   causal: bool = True, use_rope: bool = True,
                   positions: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Self-attention over the full sequence. x: [B, S, d] -> [B, S, d]."""
    B, S, _ = x.shape
    G = num_heads // num_kv_heads
    q = _split_heads(x @ params["wq"], num_heads, head_dim)
    k = _split_heads(x @ params["wk"], num_kv_heads, head_dim)
    v = _split_heads(x @ params["wv"], num_kv_heads, head_dim)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    q = q.reshape(B, S, num_kv_heads, G, head_dim)
    scores = torch.einsum("bshgd,bthd->bhgst", q.float(), k.float())
    scores = scores / math.sqrt(head_dim)
    idx = torch.arange(S, device=x.device)
    mask = locality_mask(idx, idx, is_global, window, causal)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", p, v.float())
    out = out.reshape(B, S, num_heads * head_dim).to(x.dtype)
    return out @ params["wo"]


def attention_decode(params: Params, x: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, *,
                     num_heads: int, num_kv_heads: int, head_dim: int,
                     rope_theta: float, is_global: bool = True,
                     window: int = 0, use_rope: bool = True,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> Tuple:
    """One-token decode against a KV cache.

    x: [B, 1, d]; k_cache/v_cache: [B, Hkv, S, hd]; pos: int [B] — the
    per-row index the new token is written at (tokens 0..pos[b]
    attendable). Returns (y [B, 1, d], new k_cache, new v_cache), and with
    ``k_scale`` / ``v_scale`` [B, Hkv, S, 1] (an int8 cache) also the new
    scales: (y, kc, vc, k_scale, v_scale).

    Precision follows the JAX package's serving policy: the QK and PV
    products run in the cache dtype (the compute dtype for an int8 cache,
    which is dequantized on read), only the softmax in fp32.
    """
    quant = k_scale is not None
    B = x.shape[0]
    S = k_cache.shape[2]
    G = num_heads // num_kv_heads
    pos = torch.broadcast_to(pos, (B,)).long()
    q = _split_heads(x @ params["wq"], num_heads, head_dim)     # [B,1,H,hd]
    k = _split_heads(x @ params["wk"], num_kv_heads, head_dim)  # [B,1,Hkv,hd]
    v = _split_heads(x @ params["wv"], num_kv_heads, head_dim)
    posb = pos[:, None]
    if use_rope:
        q = apply_rope(q, posb, rope_theta)
        k = apply_rope(k, posb, rope_theta)
    rows = torch.arange(B, device=x.device)
    # a row whose position is past the cache (an idle slot that kept
    # advancing) writes nothing, as the JAX package's mask-select does
    wpos = pos.clamp(max=S - 1)
    keep = (pos < S)[:, None, None]

    def write(cache, new):
        cache = cache.clone()
        cache[rows, :, wpos] = torch.where(keep, new.to(cache.dtype),
                                           cache[rows, :, wpos])
        return cache

    if quant:
        kq, ks_new = quantize(k[:, 0], scale_dtype=k_scale.dtype)
        vq, vs_new = quantize(v[:, 0], scale_dtype=v_scale.dtype)
        k_cache, v_cache = write(k_cache, kq), write(v_cache, vq)
        k_scale, v_scale = write(k_scale, ks_new), write(v_scale, vs_new)
        kc = dequantize(k_cache, k_scale, dtype=x.dtype)
        vc = dequantize(v_cache, v_scale, dtype=x.dtype)
    else:
        k_cache, v_cache = write(k_cache, k[:, 0]), write(v_cache, v[:, 0])
        kc, vc = k_cache, v_cache
    q = q.reshape(B, 1, num_kv_heads, G, head_dim)
    scores = torch.einsum("bshgd,bhtd->bhgst", q.to(kc.dtype), kc)
    scores = scores.float() / math.sqrt(head_dim)
    cols = torch.arange(S, device=x.device)[None, :]
    ok = cols <= pos[:, None]
    if window > 0 and not is_global:
        ok = ok & (cols > pos[:, None] - window)
    scores = torch.where(ok[:, None, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bhtd->bshgd", p.to(vc.dtype), vc)
    out = out.reshape(B, 1, num_heads * head_dim).to(x.dtype)
    y = out @ params["wo"]
    if quant:
        return y, k_cache, v_cache, k_scale, v_scale
    return y, k_cache, v_cache


def attention_cross(params: Params, x: torch.Tensor, k_mem: torch.Tensor,
                    v_mem: torch.Tensor, *, num_heads: int,
                    num_kv_heads: int, head_dim: int) -> torch.Tensor:
    """Cross attention against precomputed memory K/V [B, Hkv, T, hd]."""
    B, S, _ = x.shape
    G = num_heads // num_kv_heads
    q = _split_heads(x @ params["wq"], num_heads, head_dim)
    q = q.reshape(B, S, num_kv_heads, G, head_dim)
    scores = torch.einsum("bshgd,bhtd->bhgst", q.float(), k_mem.float())
    scores = scores / math.sqrt(head_dim)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bhtd->bshgd", p, v_mem.float())
    out = out.reshape(B, S, num_heads * head_dim).to(x.dtype)
    return out @ params["wo"]


def project_memory_kv(params: Params, mem: torch.Tensor, *,
                      num_kv_heads: int, head_dim: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project encoder output into cross-attention K/V [B, Hkv, T, hd]."""
    k = _split_heads(mem @ params["wk"], num_kv_heads, head_dim)
    v = _split_heads(mem @ params["wv"], num_kv_heads, head_dim)
    return k.transpose(1, 2), v.transpose(1, 2)
