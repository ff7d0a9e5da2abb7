"""The numerical design of the port's ``coalesced_gemv`` kernel, on the CPU.

The CUDA kernel (``src/repro_torch/kernels/csrc/coalesced_gemv.cu``) runs
only on the card. What it sums, and in which order, is fixed by the
wrapper's geometry, and is checked here:

  * the K split (the cluster size, and so each output's summation order) is
    a function of K alone: equal across G and N, in both dtypes;
  * the summation order, emulated in plain torch: K cut into rounds of one
    row a row group, rank q taking rounds q, q + S, ...; per rank, each row
    group's fp32 FMAs over its rows in order; the row groups of a warp
    added by the xor-shuffle tree; the warps in warp order; the ranks in
    rank order; one rounding to x's dtype. It holds the card's limits
    against the plain version (fp32 2e-4 relative and absolute; bf16 one
    ulp, rtol 1e-2 with a 1e-4 floor, as in chip_smoke.py), and a mutant
    that accumulates in bf16 does not hold the bf16 limit.

Inputs come from numpy with fixed seeds; w is scaled by 1/sqrt(K) so the
outputs are of order 1, as on the card.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels.ref import coalesced_gemv_ref

gv = importlib.import_module("repro_torch.kernels.coalesced_gemv")
LIMITS = {torch.float32: {"rtol": 2e-4, "atol": 2e-4},
          torch.bfloat16: {"rtol": 1e-2, "atol": 1e-4}}


def _inputs(G, K, N, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((G, K)).astype(np.float32)
    w = rng.standard_normal((G, K, N)).astype(np.float32) / np.sqrt(K)
    return torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype)


def emulate(x, w, *, accumulate=torch.float32):
    """The kernel's sums for every output, every add rounded to
    ``accumulate``. An FMA rounds once: its product is exact in float64 (two
    24-bit mantissas), and the float64 sum is rounded to ``accumulate``."""
    G, K = x.shape
    N = w.shape[-1]
    cluster = gv.k_split(K, x.dtype)
    groups = gv.row_groups()
    per_warp = 32 // gv.ROW_LANES
    warps = gv.THREADS // 32
    xd, wd = x.double(), w.double()
    total = None
    for q in range(cluster):
        acc = torch.zeros(G, groups, N, dtype=accumulate)
        # round m: row group r takes row m * groups + r
        for k0 in range(q * groups, K, cluster * groups):
            ks = torch.arange(k0, min(k0 + groups, K))
            r = ks - k0
            fma = acc[:, r].double() + xd[:, ks, None] * wd[:, ks]
            acc[:, r] = fma.to(accumulate)
        # the xor-shuffle tree: offsets ROW_LANES, 2 ROW_LANES, ... pair
        # group i with group i ^ 1, then pair sums with pair sums
        tree = acc.view(G, warps, per_warp, N)
        while tree.shape[2] > 1:
            tree = tree[:, :, 0::2] + tree[:, :, 1::2]
        block = tree[:, 0, 0]
        for i in range(1, warps):
            block = block + tree[:, i, 0]
        total = block if total is None else total + block
    return total.to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [1, 300, 2048, 4096, 16384])
def test_k_split_depends_on_k_alone(K, dtype):
    """One K gives one split, whatever G and N the launch holds, and every
    rank has rows: at least one round of the row groups."""
    configs = {cfg.cluster for cfg in (
        gv.launch_config(G, K, N, dtype)
        for G, N in ((1, 64), (2, 4096), (4, 4096), (8, 4096),
                     (4, 16384), (3, 320)))}
    assert configs == {gv.k_split(K, dtype)}
    cluster = gv.k_split(K, dtype)
    assert 1 <= cluster <= gv.MAX_CLUSTER
    assert (cluster - 1) * gv.row_groups() < K
    # one rank for every RANK_ROWS rows, unless the cluster is at its cap
    assert cluster == min(gv.MAX_CLUSTER, -(-K // gv.RANK_ROWS),
                          -(-K // gv.row_groups()))


def test_split_fills_the_card_at_small_g():
    """The LSTM shape at G = 2 (K 2048, N 4096) launches at least four
    blocks for each of the H100's 132 SMs in both dtypes."""
    for dtype in (torch.float32, torch.bfloat16):
        cfg = gv.launch_config(2, 2048, 4096, dtype)
        assert cfg.grid[0] * cfg.grid[1] * cfg.grid[2] >= 4 * 132


# (G, K, N): one rank (K 1 and 30: fewer rows than row groups; 300: a
# ragged last round), the LSTM depth (five ranks), and ragged last rounds at
# five and eight ranks
SHAPES = [(3, 1, 64), (2, 30, 64), (2, 300, 128), (2, 2048, 128),
          (2, 2049, 64), (1, 4100, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,K,N", SHAPES)
def test_summation_order_holds_card_limit(G, K, N, dtype):
    x, w = _inputs(G, K, N, dtype, seed=G + K + N)
    got = emulate(x, w)
    want = coalesced_gemv_ref(x, w)
    assert got.dtype == dtype and tuple(got.shape) == (G, N)
    torch.testing.assert_close(got.float(), want.float(), **LIMITS[dtype])


@pytest.mark.parametrize("G,K,N", [(2, 2048, 128), (2, 2049, 64),
                                   (1, 4100, 64)])
def test_bf16_accumulator_breaks_card_limit(G, K, N):
    """The limit sees the accumulator's type: the same order with every add
    rounded to bf16 falls outside it."""
    x, w = _inputs(G, K, N, torch.bfloat16, seed=G + K + N)
    got = emulate(x, w, accumulate=torch.bfloat16)
    want = coalesced_gemv_ref(x, w)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(got.float(), want.float(),
                                   **LIMITS[torch.bfloat16])
