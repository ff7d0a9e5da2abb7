"""Plain PyTorch versions of this package's kernels.

The CPU tests hold them against the JAX package's Pallas kernels, the
wrappers use them for tensors that lie on the CPU, and ``chip_smoke.py``
holds each hand-written kernel against its plain version on the card. A
CUDA tensor never reaches them through a wrapper.
"""
from __future__ import annotations

import torch


def coalesced_gemm_ref(a_packed: torch.Tensor, b_stacked: torch.Tensor,
                       group_ids: torch.Tensor, bm: int) -> torch.Tensor:
    """Reference for the grouped superkernel.

    a_packed: [M_pad, K] — problems concatenated along m (each problem's rows
    padded to a multiple of ``bm``); b_stacked: [G, K, N]; group_ids:
    [M_pad // bm] int32 mapping each m-tile to its problem. Accumulates in
    fp32 and returns A's dtype.
    """
    M, K = a_packed.shape
    tiles = a_packed.reshape(M // bm, bm, K).float()
    b_per_tile = b_stacked[group_ids.long()].float()         # [T, K, N]
    out = torch.einsum("tmk,tkn->tmn", tiles, b_per_tile)
    return out.reshape(M, b_stacked.shape[-1]).to(a_packed.dtype)


def coalesced_gemv_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Batched matvec: x [G, K], w [G, K, N] -> [G, N]. Accumulates in fp32
    and returns x's dtype."""
    return torch.einsum("gk,gkn->gn", x.float(), w.float()).to(x.dtype)


_NEG = -2.0e38


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """Dense attention oracle on q, k, v [BH, S, D] -> [BH, S, D]: a masked
    softmax in fp32 (scale 1/sqrt(D), masked scores filled with -2e38, as
    the flash kernel does), returned in q's dtype."""
    S, D = int(q.shape[1]), int(q.shape[2])
    scale = 1.0 / D ** 0.5
    logits = torch.einsum("bsd,btd->bst", q.float(), k.float()) * scale
    rows = torch.arange(S, device=q.device)[:, None]
    cols = torch.arange(S, device=q.device)[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        ok &= cols <= rows
    if window > 0:
        ok &= cols > rows - window
    p = torch.softmax(logits.masked_fill_(~ok, _NEG), dim=-1)
    return torch.einsum("bst,btd->bsd", p, v.float()).to(q.dtype)
