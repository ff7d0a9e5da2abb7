"""The numerical design of the port's ``coalesced_gemm`` kernel, on the CPU.

The CUDA kernel (``src/repro_torch/kernels/csrc/coalesced_gemm.cu``) runs
only on the card. What it sums, and in which order, is fixed by the
wrapper's geometry, and is checked here:

  * the K split (the cluster size, and so each row's summation order) is a
    function of K alone: equal across M, N and G;
  * the bf16 summation order, emulated in plain torch: bf16 x bf16 products
    exact in fp32, 16-deep MMA sums added to an fp32 accumulator k tile by
    k tile within a cluster rank, the ranks' partials added in rank order,
    then one rounding to bf16. It holds the card's limit against the plain
    version (one bf16 ulp: rtol 1e-2 with a 1e-4 floor, as in
    chip_smoke.py) at small path-like shapes, and a mutant that accumulates
    in bf16 does not;
  * the fp32 path, 3xTF32 emulated the same way: operands split into
    TF32 hi = rna(x) and lo = rna(x - hi), three 8-deep MMAs a k step
    (a_lo b_hi, a_hi b_lo, a_hi b_hi) added to the fp32 accumulator, the
    ranks in order. It holds the fp32 limit of the card's checks (2e-4
    relative and absolute); plain TF32 (a_hi b_hi alone) does not.

Inputs come from numpy with fixed seeds; B is scaled by 1/sqrt(K) so the
outputs are of order 1, as on the card.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels.ref import coalesced_gemm_ref

cg = importlib.import_module("repro_torch.kernels.coalesced_gemm")
CARD_TOL = {"rtol": 1e-2, "atol": 1e-4}     # bf16, one ulp
FP32_TOL = {"rtol": 2e-4, "atol": 2e-4}     # fp32, as chip_smoke.py
MMA_K = 16                                  # depth of one m16n8k16 MMA
TF32_K = 8                                  # depth of one m16n8k8 MMA


def _packed(rows, K, N, pad_tiles, shared, seed, bm=8,
            dtype=torch.bfloat16):
    """A, B, group ids as the executor packs them: each problem's rows
    padded to bm, then ``pad_tiles`` all-zero m-tiles of group 0."""
    rng = np.random.default_rng(seed)
    G = 1 if shared else len(rows)
    parts, gids = [], []
    for p, m in enumerate(rows):
        m_pad = -(-m // bm) * bm
        a = np.zeros((m_pad, K), np.float32)
        a[:m] = rng.standard_normal((m, K))
        parts.append(a)
        gids += [0 if shared else p] * (m_pad // bm)
    parts.append(np.zeros((pad_tiles * bm, K), np.float32))
    gids += [0] * pad_tiles
    b = rng.standard_normal((G, K, N)).astype(np.float32) / np.sqrt(K)
    return (torch.from_numpy(np.concatenate(parts)).to(dtype),
            torch.from_numpy(b).to(dtype),
            torch.tensor(gids, dtype=torch.int32))


def emulate_bf16(a, b, gid, bm, *, accumulate=torch.float32):
    """The bf16 kernel's sums for every row: per cluster rank, its k tiles
    in order, each 16-deep MMA sum added to the accumulator (held in
    ``accumulate``); then the ranks' fp32 partials added in rank order and
    rounded once to bf16."""
    M, K = a.shape
    N = b.shape[-1]
    cluster, per_rank = cg.k_split(K, torch.bfloat16)
    span = per_rank * cg.k_tile(torch.bfloat16)
    rows_g = gid.long().repeat_interleave(bm)
    out = torch.empty(M, N)
    for g in rows_g.unique().tolist():
        idx = (rows_g == g).nonzero().flatten()
        x, w = a[idx].float(), b[g].float()
        total = None
        for q in range(cluster):
            acc = torch.zeros(len(idx), N, dtype=accumulate)
            for k in range(q * span, min((q + 1) * span, K), MMA_K):
                # bf16 products are exact in fp32; the MMA sums 16 of them
                mma = x[:, k:k + MMA_K] @ w[k:k + MMA_K]
                acc = (acc.float() + mma).to(accumulate)
            total = acc.float() if total is None else total + acc.float()
        out[idx] = total
    return out.bfloat16()


def tf32_rna(x):
    """x rounded to TF32 (10-bit mantissa), to nearest with ties away from
    zero: the kernel's integer add-and-mask."""
    bits = (x.view(torch.int32) + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def emulate_3xtf32(a, b, gid, bm, *, terms=3):
    """The fp32 kernel's sums for every row: per cluster rank, its 8-deep
    k steps in order, each adding a_lo b_hi, a_hi b_lo and a_hi b_hi
    (``terms=1``: a_hi b_hi alone, plain TF32) to the fp32 accumulator;
    then the ranks' partials in rank order. The kernel's MMA "a" operand is
    B (the weights) and its "b" operand the rows of A."""
    M, K = a.shape
    N = b.shape[-1]
    cluster, per_rank = cg.k_split(K, torch.float32)
    span = per_rank * cg.k_tile(torch.float32)
    rows_g = gid.long().repeat_interleave(bm)
    out = torch.empty(M, N)
    for g in rows_g.unique().tolist():
        idx = (rows_g == g).nonzero().flatten()
        x, w = a[idx], b[g]
        xh, wh = tf32_rna(x), tf32_rna(w)
        xl, wl = tf32_rna(x - xh), tf32_rna(w - wh)
        total = None
        for q in range(cluster):
            acc = torch.zeros(len(idx), N)
            for k in range(q * span, min((q + 1) * span, K), TF32_K):
                ks = slice(k, k + TF32_K)
                if terms == 3:
                    acc = acc + xh[:, ks] @ wl[ks]
                    acc = acc + xl[:, ks] @ wh[ks]
                acc = acc + xh[:, ks] @ wh[ks]
            total = acc if total is None else total + acc
        out[idx] = total
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [1, 300, 2048, 4096, 11008, 16384])
def test_k_split_depends_on_k_alone(K, dtype):
    """One K gives one split, whatever else the launch holds, and every
    cluster rank gets k tiles."""
    configs = {(cfg.cluster, cfg.tiles_per_rank) for cfg in (
        cg.launch_config(M, K, N, bm, G, dtype)
        for M, N, bm, G in ((8, 128, 8, 1), (16, 16384, 8, 2),
                            (64, 4096, 8, 2), (512, 65536, 16, 8),
                            (24, 256, 8, 3)))}
    assert configs == {cg.k_split(K, dtype)}
    cluster, per_rank = cg.k_split(K, dtype)
    tiles = -(-K // cg.k_tile(dtype))
    assert 1 <= cluster <= cg.MAX_CLUSTER
    assert cluster * per_rank >= tiles > (cluster - 1) * per_rank
    # a rank streams RANK_TILES k tiles, the same bytes of B in both dtypes,
    # unless the cluster is at its cap
    assert per_rank <= cg.RANK_TILES or cluster == cg.MAX_CLUSTER


# small path-like shapes: decode grouped, the shared regime at its K, and
# the ragged prefill+decode group with its pad tiles (m-tiles [0,0,0,0,1,
# 0,0,0]: B[0] read by 7 of them)
SHAPES = [((4, 4), 4096, 256, 0, False), ((8,), 16384, 128, 0, True),
          ((32, 4), 4096, 256, 3, False)]


@pytest.mark.parametrize("rows,K,N,pad_tiles,shared", SHAPES)
def test_bf16_summation_order_holds_card_limit(rows, K, N, pad_tiles,
                                               shared):
    a, b, gid = _packed(rows, K, N, pad_tiles, shared, seed=K + N)
    got = emulate_bf16(a, b, gid, 8)
    want = coalesced_gemm_ref(a, b, gid, 8)
    torch.testing.assert_close(got.float(), want.float(), **CARD_TOL)
    m_real = sum(-(-m // 8) * 8 for m in rows)
    assert torch.count_nonzero(got[m_real:]) == 0     # pad rows stay zero


@pytest.mark.parametrize("rows,K,N,pad_tiles,shared", SHAPES)
def test_bf16_accumulator_breaks_card_limit(rows, K, N, pad_tiles, shared):
    """The limit sees the accumulator's type: the same order with the
    accumulator rounded to bf16 after every MMA falls outside it."""
    a, b, gid = _packed(rows, K, N, pad_tiles, shared, seed=K + N)
    got = emulate_bf16(a, b, gid, 8, accumulate=torch.bfloat16)
    want = coalesced_gemm_ref(a, b, gid, 8)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(got.float(), want.float(), **CARD_TOL)


@pytest.mark.parametrize("rows,K,N,pad_tiles,shared", SHAPES[::2])
def test_3xtf32_holds_fp32_limit_plain_tf32_does_not(rows, K, N, pad_tiles,
                                                     shared):
    a, b, gid = _packed(rows, K, N, pad_tiles, shared, seed=K + N + 1,
                        dtype=torch.float32)
    want = coalesced_gemm_ref(a, b, gid, 8)
    torch.testing.assert_close(emulate_3xtf32(a, b, gid, 8), want,
                               **FP32_TOL)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(emulate_3xtf32(a, b, gid, 8, terms=1),
                                   want, **FP32_TOL)
