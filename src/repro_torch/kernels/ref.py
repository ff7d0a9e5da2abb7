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
