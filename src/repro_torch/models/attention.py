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

A local (windowed) layer attends to ``pos - window < col <= pos``. At
``S >= CHUNKED_THRESHOLD`` (a multiple of ``Q_CHUNK``) full attention takes
the JAX package's chunked path, ``_attention_chunked``: one ``Q_CHUNK`` of
queries at a time, a local layer reading only its ``[Q_CHUNK + window]``
K/V band, each chunk recomputed in the backward pass. Shorter sequences
build the whole ``[S, S]`` scores and select the band by a mask, which
gives the same softmax. Decode selects the band by a mask too.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import SeqBlock
from repro_torch.models.kvquant import dequantize, quantize
from repro_torch.models.layers import Params, apply_rope

NEG_INF = -2.0e38


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n, hd))


class _ScoresF32(torch.autograd.Function):
    """``qb @ kbᵀ`` of [N, m, hd] by [N, T, hd] with an fp32 result and the
    operands left in their dtype: on the card one cuBLAS batched product
    on the tensor cores (``bmm`` with ``out_dtype``, which has no
    derivative of its own). The backward is the JAX package's transpose
    rule for ``preferred_element_type=float32``: the fp32 cotangent times
    the other operand widened to fp32, rounded to the operand's dtype. On
    the CPU (tests of this plumbing) the forward widens both operands."""

    @staticmethod
    def forward(ctx, qb: torch.Tensor, kb: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(qb, kb)
        if qb.is_cuda:
            return torch.bmm(qb, kb.transpose(1, 2), out_dtype=torch.float32)
        return torch.bmm(qb.float(), kb.float().transpose(1, 2))

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        qb, kb = ctx.saved_tensors
        gq = gk = None
        if ctx.needs_input_grad[0]:
            gq = torch.bmm(g, kb.float()).to(qb.dtype)
        if ctx.needs_input_grad[1]:
            gk = torch.bmm(g.transpose(1, 2), qb.float()).to(kb.dtype)
        return gq, gk


def _bmm_scores(q: torch.Tensor, k: torch.Tensor,
                k_heads_first: bool) -> torch.Tensor:
    """``qk_scores`` as one batched product over (batch, kv head)."""
    B, s, H, G, hd = q.shape
    kh = k if k_heads_first else k.transpose(1, 2)      # [B, H, T, hd]
    T = int(kh.shape[2])
    qb = q.permute(0, 2, 3, 1, 4).reshape(B * H, G * s, hd)
    kb = kh.reshape(B * H, T, hd)
    return _ScoresF32.apply(qb, kb).reshape(B, H, G, s, T)


def qk_scores(q: torch.Tensor, k: torch.Tensor, *,
              k_heads_first: bool = False) -> torch.Tensor:
    """GQA scores q·kᵀ with an fp32 result, the JAX package's
    ``einsum(..., preferred_element_type=float32)``: q [B, s, Hkv, G, hd]
    against k [B, T, Hkv, hd] (or [B, Hkv, T, hd] with ``k_heads_first``)
    -> [B, Hkv, G, s, T] fp32.

    A bf16 product on the card runs on the tensor cores in bf16 with an
    fp32 sum (``_ScoresF32``): widening the operands first would send it to
    an fp32 GEMM without tensor cores. fp32 operands, and every product on
    the CPU, widen as before: an fp32 einsum."""
    if q.is_cuda and q.dtype == torch.bfloat16 and k.dtype == q.dtype:
        return _bmm_scores(q, k, k_heads_first)
    eq = "bshgd,bhtd->bhgst" if k_heads_first else "bshgd,bthd->bhgst"
    return torch.einsum(eq, q.float(), k.float())


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


# sequences at or above this length (and a multiple of Q_CHUNK) take the
# chunked path: never materialize [B, H, S, S]
CHUNKED_THRESHOLD = 2048
Q_CHUNK = 512


def _scores_to_out(s: torch.Tensor, ok: torch.Tensor, v: torch.Tensor,
                   head_dim: int) -> torch.Tensor:
    """Masked fp32 softmax of one chunk's scores [B, Hkv, G, bq, T] against
    v [B, T, Hkv, hd] -> [B, bq, Hkv, G, hd] (fp32)."""
    s = s / math.sqrt(head_dim)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgst,bthd->bshgd", p, v.float())


def _attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       is_global: bool, window: int, causal: bool,
                       head_dim: int) -> torch.Tensor:
    """Flash-style chunked attention, the JAX package's
    ``_attention_chunked``: a loop over ``Q_CHUNK`` query chunks, each with
    full-row scores [B, Hkv, G, bq, S] that live only for the chunk.
    q: [B, S, Hkv, G, hd]; k, v: [B, S, Hkv, hd] -> [B, S, Hkv·G·hd].

    Three branches, as in the reference. With a window that fits well under
    S (``bq + window < S``, causal), a global layer takes ``full_branch``
    and a local layer ``banded_branch``, which slices only the
    ``[bq + window]`` K/V band starting at ``clip(idx·bq − window, 0,
    S − Wlen)``; otherwise ``masked_fallback`` masks full-row scores. The
    reference selects the first two with ``lax.cond`` on a traced flag;
    here the flag is a Python bool. With grad enabled each chunk runs under
    ``torch.utils.checkpoint`` (``jax.checkpoint(chunk)``), so the backward
    recomputes its scores and training memory stays O(S·bq); the band's
    start is a Python int, fixed before the recompute.
    """
    B, S, Hkv, G, hd = q.shape
    bq = Q_CHUNK
    assert S % bq == 0, (S, bq)
    dev = q.device
    cols = torch.arange(S, device=dev)
    Wlen = bq + window                      # band length per q chunk
    banded = window > 0 and causal and Wlen < S

    def chunk(qi: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              idx: int) -> torch.Tensor:
        rows = idx * bq + torch.arange(bq, device=dev)
        if banded and not is_global:                    # banded_branch
            start = min(max(idx * bq - window, 0), S - Wlen)
            kb, vb = k[:, start:start + Wlen], v[:, start:start + Wlen]
            bcols = start + torch.arange(Wlen, device=dev)
            ok = (bcols[None, :] <= rows[:, None]) \
                & (bcols[None, :] > rows[:, None] - window)
        else:                               # full_branch / masked_fallback
            kb, vb = k, v
            ok = locality_mask(rows, cols, is_global or banded, window,
                               causal)
        s = qk_scores(qi, kb)
        return _scores_to_out(s, ok, vb, head_dim).to(q.dtype)

    outs = []
    for idx in range(S // bq):
        qi = q[:, idx * bq:(idx + 1) * bq]
        if torch.is_grad_enabled():
            outs.append(checkpoint(chunk, qi, k, v, idx,
                                   use_reentrant=False))
        else:
            outs.append(chunk(qi, k, v, idx))
    return torch.cat(outs, dim=1).reshape(B, S, Hkv * G * hd)


def attention_full(params: Params, x: torch.Tensor, *, num_heads: int,
                   num_kv_heads: int, head_dim: int, rope_theta: float,
                   is_global: bool = True, window: int = 0,
                   causal: bool = True, use_rope: bool = True,
                   positions: Optional[torch.Tensor] = None,
                   return_kv: bool = False):
    """Self-attention over the full sequence. x: [B, S, d] -> [B, S, d];
    with ``return_kv`` also its k (after rope) and v [B, S, Hkv, hd], which
    the prefill writes to the cache: projected once, where the JAX package
    projects them again and leaves XLA to merge the two."""
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
    if S >= CHUNKED_THRESHOLD and S % Q_CHUNK == 0:
        out = _attention_chunked(q, k, v, is_global=is_global,
                                 window=window, causal=causal,
                                 head_dim=head_dim).to(x.dtype)
    else:
        scores = qk_scores(q, k)
        idx = torch.arange(S, device=x.device)
        mask = locality_mask(idx, idx, is_global, window, causal)
        out = _scores_to_out(scores, mask, v, head_dim)
        out = out.reshape(B, S, num_heads * head_dim).to(x.dtype)
    y = out @ params["wo"]
    return (y, k, v) if return_kv else y


def _combine_blocks(scores: torch.Tensor, v: torch.Tensor,
                    seq: SeqBlock) -> torch.Tensor:
    """Softmax · v over a sequence split across ranks, each holding a
    block of the columns: masked fp32 scores [B, Hkv, G, s, T_block]
    against v [B, Hkv, T_block, hd]. In fp32: the max over the ranks
    (all-reduce), then the sum of the exps and the sum of the unnormalised
    p·v (all-reduces); p·v runs in v's dtype, as the unsharded path's.
    Returns [B, s, Hkv, G, hd] fp32."""
    import torch.distributed as dist
    m = seq.all_reduce(scores.amax(dim=-1, keepdim=True), dist.ReduceOp.MAX)
    p = torch.exp(scores - m)
    denom = seq.all_reduce(p.sum(dim=-1, keepdim=True))
    out = seq.all_reduce(
        torch.einsum("bhgst,bhtd->bshgd", p.to(v.dtype), v).float())
    return out / denom.permute(0, 3, 1, 2, 4)


def attention_decode(params: Params, x: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, *,
                     num_heads: int, num_kv_heads: int, head_dim: int,
                     rope_theta: float, is_global: bool = True,
                     window: int = 0, use_rope: bool = True,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     seq: Optional[SeqBlock] = None) -> Tuple:
    """One-token decode against a KV cache.

    x: [B, 1, d]; k_cache/v_cache: [B, Hkv, S, hd]; pos: int [B] — the
    per-row index the new token is written at (tokens 0..pos[b]
    attendable). Returns (y [B, 1, d], new k_cache, new v_cache), and with
    ``k_scale`` / ``v_scale`` [B, Hkv, S, 1] (an int8 cache) also the new
    scales: (y, kc, vc, k_scale, v_scale).

    Precision follows the JAX package's serving policy: the QK and PV
    products run in the cache dtype (the compute dtype for an int8 cache,
    which is dequantized on read), only the softmax in fp32.

    ``seq``: the cache (and its scales) is this rank's block of a cache
    sequence-sharded over ``seq.axes`` (``sharding.seq_block``), columns
    ``seq.offset`` on of ``seq.total``. The rank writes the new k / v only
    where it holds ``pos`` (the clamp and the "past the cache writes
    nothing" rule on the global columns), scores its block by global
    column, masks a local layer's band over global columns (a band may
    straddle two ranks) and combines the softmax across the ranks in fp32
    (``_combine_blocks``).
    """
    quant = k_scale is not None
    B = x.shape[0]
    S = k_cache.shape[2] if seq is None else seq.total
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
    if seq is not None:
        # the rank's block holds global columns offset .. offset + S_block
        n = k_cache.shape[2]
        wpos = wpos - seq.offset
        keep = keep & ((wpos >= 0) & (wpos < n))[:, None, None]
        wpos = wpos.clamp(0, n - 1)

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
    else:
        k_cache, v_cache = write(k_cache, k[:, 0]), write(v_cache, v[:, 0])
    if seq is not None:
        # the block's global columns; a local layer's band is the mask
        # below
        cols = seq.offset + torch.arange(k_cache.shape[2],
                                         device=x.device)[None, :]

        def band(c):
            return c
    elif 0 < window < S and not is_global:
        # a local layer reads only its rows' last ``window`` entries, as
        # the JAX package's banded decode does
        start = (pos - window + 1).clamp(0, S - window)
        cols = start[:, None] + torch.arange(window, device=x.device)

        def band(c):
            idx = cols[:, None, :, None].expand(B, c.shape[1], window,
                                                c.shape[3])
            return c.gather(2, idx)
    else:
        cols = torch.arange(S, device=x.device)[None, :]

        def band(c):
            return c
    if quant:
        kc = dequantize(band(k_cache), band(k_scale), dtype=x.dtype)
        vc = dequantize(band(v_cache), band(v_scale), dtype=x.dtype)
    else:
        kc, vc = band(k_cache), band(v_cache)
    q = q.reshape(B, 1, num_kv_heads, G, head_dim)
    scores = torch.einsum("bshgd,bhtd->bhgst", q.to(kc.dtype), kc)
    scores = scores.float() / math.sqrt(head_dim)
    ok = cols <= pos[:, None]
    if window > 0 and not is_global:
        ok = ok & (cols > pos[:, None] - window)
    scores = torch.where(ok[:, None, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    if seq is None:
        p = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhgst,bhtd->bshgd", p.to(vc.dtype), vc)
    else:
        out = _combine_blocks(scores, vc, seq)
    out = out.reshape(B, 1, num_heads * head_dim).to(x.dtype)
    y = out @ params["wo"]
    if quant:
        return y, k_cache, v_cache, k_scale, v_scale
    return y, k_cache, v_cache


def attention_cross(params: Params, x: torch.Tensor, k_mem: torch.Tensor,
                    v_mem: torch.Tensor, *, num_heads: int,
                    num_kv_heads: int, head_dim: int,
                    seq: Optional[SeqBlock] = None) -> torch.Tensor:
    """Cross attention against precomputed memory K/V [B, Hkv, T, hd];
    with ``seq`` the rank's block of a memory sequence-sharded across
    ranks, the softmax combined across them (``_combine_blocks``)."""
    B, S, _ = x.shape
    G = num_heads // num_kv_heads
    q = _split_heads(x @ params["wq"], num_heads, head_dim)
    q = q.reshape(B, S, num_kv_heads, G, head_dim)
    scores = qk_scores(q, k_mem, k_heads_first=True)
    scores = scores / math.sqrt(head_dim)
    if seq is None:
        p = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhgst,bhtd->bshgd", p, v_mem.float())
    else:
        out = _combine_blocks(scores, v_mem.float(), seq)
    out = out.reshape(B, S, num_heads * head_dim).to(x.dtype)
    return out @ params["wo"]


def project_memory_kv(params: Params, mem: torch.Tensor, *,
                      num_kv_heads: int, head_dim: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project encoder output into cross-attention K/V [B, Hkv, T, hd]."""
    k = _split_heads(mem @ params["wk"], num_kv_heads, head_dim)
    v = _split_heads(mem @ params["wv"], num_kv_heads, head_dim)
    return k.transpose(1, 2), v.transpose(1, 2)
