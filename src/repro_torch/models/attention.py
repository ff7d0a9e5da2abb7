"""Grouped-query attention (GQA/MQA) with optional sliding-window locality.

Two execution modes, as in the JAX package's ``models/attention.py``:
  * full   — prompt prefill self-attention over the whole sequence
    (causal), optional sliding window;
  * decode — one new token per row against a slotted KV cache with per-row
    positions, returning the updated cache (functionally: a new tensor, the
    input cache is left as it was).

A local (windowed) layer attends to ``pos - window < col <= pos``. The JAX
package reads only that band on long sequences; here the same set is
selected by a mask over the whole row, which gives the same softmax.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.models.layers import Params, apply_rope

NEG_INF = -2.0e38


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n, hd))


def locality_mask(rows: torch.Tensor, cols: torch.Tensor, is_global: bool,
                  window: int) -> torch.Tensor:
    """Boolean causal mask [S, T] (True = attendable), banded to ``window``
    on local layers."""
    ok = cols[None, :] <= rows[:, None]
    if window > 0 and not is_global:
        ok = ok & (cols[None, :] > rows[:, None] - window)
    return ok


def attention_full(params: Params, x: torch.Tensor, *, num_heads: int,
                   num_kv_heads: int, head_dim: int, rope_theta: float,
                   is_global: bool = True, window: int = 0) -> torch.Tensor:
    """Causal self-attention over the full sequence. x: [B, S, d] -> [B, S, d]."""
    B, S, _ = x.shape
    G = num_heads // num_kv_heads
    q = _split_heads(x @ params["wq"], num_heads, head_dim)
    k = _split_heads(x @ params["wk"], num_kv_heads, head_dim)
    v = _split_heads(x @ params["wv"], num_kv_heads, head_dim)
    positions = torch.arange(S, device=x.device)[None, :]
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    q = q.reshape(B, S, num_kv_heads, G, head_dim)
    scores = torch.einsum("bshgd,bthd->bhgst", q.float(), k.float())
    scores = scores / math.sqrt(head_dim)
    idx = torch.arange(S, device=x.device)
    mask = locality_mask(idx, idx, is_global, window)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", p, v.float())
    out = out.reshape(B, S, num_heads * head_dim).to(x.dtype)
    return out @ params["wo"]


def attention_decode(params: Params, x: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, *,
                     num_heads: int, num_kv_heads: int, head_dim: int,
                     rope_theta: float, is_global: bool = True,
                     window: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode against a KV cache.

    x: [B, 1, d]; k_cache/v_cache: [B, Hkv, S, hd]; pos: int [B] — the
    per-row index the new token is written at (tokens 0..pos[b]
    attendable). Returns (y [B, 1, d], new k_cache, new v_cache).

    Precision follows the JAX package's serving policy: the QK and PV
    products run in the cache dtype, only the softmax in fp32.
    """
    B = x.shape[0]
    S = k_cache.shape[2]
    G = num_heads // num_kv_heads
    pos = torch.broadcast_to(pos, (B,)).long()
    q = _split_heads(x @ params["wq"], num_heads, head_dim)     # [B,1,H,hd]
    k = _split_heads(x @ params["wk"], num_kv_heads, head_dim)  # [B,1,Hkv,hd]
    v = _split_heads(x @ params["wv"], num_kv_heads, head_dim)
    posb = pos[:, None]
    q = apply_rope(q, posb, rope_theta)
    k = apply_rope(k, posb, rope_theta)
    rows = torch.arange(B, device=x.device)
    k_cache = k_cache.clone()
    v_cache = v_cache.clone()
    # a row whose position is past the cache (an idle slot that kept
    # advancing) writes nothing, as the JAX package's mask-select does
    wpos = pos.clamp(max=S - 1)
    keep = (pos < S)[:, None, None]
    k_cache[rows, :, wpos] = torch.where(
        keep, k[:, 0].to(k_cache.dtype), k_cache[rows, :, wpos])
    v_cache[rows, :, wpos] = torch.where(
        keep, v[:, 0].to(v_cache.dtype), v_cache[rows, :, wpos])
    q = q.reshape(B, 1, num_kv_heads, G, head_dim)
    scores = torch.einsum("bshgd,bhtd->bhgst", q.to(k_cache.dtype), k_cache)
    scores = scores.float() / math.sqrt(head_dim)
    cols = torch.arange(S, device=x.device)[None, :]
    ok = cols <= pos[:, None]
    if window > 0 and not is_global:
        ok = ok & (cols > pos[:, None] - window)
    scores = torch.where(ok[:, None, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bhtd->bshgd", p.to(v_cache.dtype), v_cache)
    out = out.reshape(B, 1, num_heads * head_dim).to(x.dtype)
    return out @ params["wo"], k_cache, v_cache
