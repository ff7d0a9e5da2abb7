"""The port's matvec regime against the JAX package's, on the CPU.

The plain PyTorch ``coalesced_gemv`` (what the wrapper runs on a CPU tensor)
is held against the Pallas kernel in interpret mode; ``ops.coalesced_matvec``
and ``SuperkernelExecutor.matvec`` against theirs, outputs and cache
accounting alike. Inputs are made with numpy from a seed and handed to both.
Tolerances: fp32 2e-4 (the gemv tolerance of tests/test_kernels.py: both
sides accumulate in fp32, in different orders); bf16 8e-2 relative with an
8x absolute floor, the bf16 GEMM tolerance of tests/test_kernels.py
(outputs here are of order sqrt(K), and both sides round them to bf16).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dispatch import SuperkernelExecutor as JaxExecutor
from repro.core.plancache import PlanCache as JaxPlanCache
from repro.kernels import ops as jax_ops
from repro.kernels.coalesced_gemv import coalesced_gemv as jax_gemv
from repro_torch.core.dispatch import SuperkernelExecutor
from repro_torch.core.plancache import PlanCache
from repro_torch.kernels import ops

# the module (the package re-exports the function under the same name)
gv = importlib.import_module("repro_torch.kernels.coalesced_gemv")

TOL = {"float32": (2e-4, 2e-4), "bfloat16": (8e-2, 8 * 8e-2)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(x: np.ndarray, dtype: str = "float32"):
    """The same values as a JAX array and a CPU tensor of ``dtype``."""
    return (jnp.asarray(x).astype(JNP[dtype]),
            torch.from_numpy(x).to(TORCH[dtype]))


def _close(got: torch.Tensor, want, dtype: str = "float32"):
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,K,N", [(1, 128, 128), (3, 256, 384),
                                   (8, 512, 128)])
def test_plain_coalesced_gemv_matches_pallas(G, K, N, dtype):
    jx, tx = _both(_np((G, K), 0), dtype)
    jw, tw = _both(_np((G, K, N), 1), dtype)
    want = jax_gemv(jx, jw, bn=128, bk=128, interpret=True)
    got = gv.coalesced_gemv(tx, tw)
    assert got.dtype == TORCH[dtype] and tuple(got.shape) == (G, N)
    _close(got, want, dtype)


def _matvec_inputs(dims, seed=0):
    """(x [k], w [k, n]) per problem, as JAX arrays and CPU tensors."""
    jx, tx, jw, tw = [], [], [], []
    for i, (k, n) in enumerate(dims):
        a, b = _both(_np((k,), seed + 2 * i))
        jx.append(a)
        tx.append(b)
        a, b = _both(_np((k, n), seed + 2 * i + 1))
        jw.append(a)
        tw.append(b)
    return jx, tx, jw, tw


@pytest.mark.parametrize("shared", [False, True])
def test_coalesced_matvec_matches(shared):
    """Shared weights go through the GEMM superkernel, distinct (ragged)
    weights through the gemv kernel; both match the JAX entry point."""
    dims = [(192, 320)] * 4 if shared else \
        [(192, 320), (100, 130), (256, 64), (77, 320)]
    jx, tx, jw, tw = _matvec_inputs(dims)
    if shared:
        jw, tw = [jw[0]] * 4, [tw[0]] * 4
    want = jax_ops.coalesced_matvec(jx, jw, interpret=True)
    got = ops.coalesced_matvec(tx, tw)
    for g, w, x, wt in zip(got, want, tx, tw):
        assert tuple(g.shape) == tuple(w.shape) == (int(wt.shape[1]),)
        _close(g, w)
        torch.testing.assert_close(g, x @ wt, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("shared", [False, True])
def test_executor_matvec_matches_and_counts(shared):
    """SuperkernelExecutor.matvec over 3 calls with G = 3 (padded to 4):
    the same outputs (2e-4) and the same cache accounting, field by field,
    as the JAX executor; ``retraces`` (kernel builds here) stays 0 on the
    CPU."""
    dims = [(200, 300)] * 3 if shared else [(200, 300), (130, 256),
                                            (256, 100)]
    jx, tx, jw, tw = _matvec_inputs(dims, seed=5)
    if shared:
        jw, tw = [jw[0]] * 3, [tw[0]] * 3
    jex = JaxExecutor(JaxPlanCache(32), bm=8)
    tex = SuperkernelExecutor(PlanCache(32), bm=8)
    for _ in range(3):
        want = jex.matvec(jx, jw, interpret=True)
        got = tex.matvec(tx, tw)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert tuple(g.shape) == tuple(w.shape)
            _close(g, w)
    for f in ("dispatches", "weight_hits", "weight_misses",
              "weight_invalidations", "bytes_not_copied"):
        assert getattr(tex.stats, f) == getattr(jex.stats, f), f
    assert tex.stats.dispatches == 3
    assert tex.stats.retraces == 0
    assert tex.stats.weight_hit_rate == pytest.approx(2 / 3)


def test_executor_matvec_hot_swap_by_replacement():
    """A hot-swap replaces a weight tensor (new object) under the same
    dispatch slot: the packed stack is rebuilt, the stale one dropped, and
    the output follows the new weights."""
    _, tx, _, tw = _matvec_inputs([(128, 128), (128, 256)], seed=9)
    ex = SuperkernelExecutor(PlanCache(32), bm=8)
    ex.matvec(tx, tw, group="rnn-slot")
    ex.matvec(tx, tw, group="rnn-slot")
    assert (ex.stats.weight_hits, ex.stats.weight_misses) == (1, 1)
    new_w = torch.from_numpy(_np((128, 256), 99))
    out = ex.matvec(tx, [tw[0], new_w], group="rnn-slot")
    assert ex.stats.weight_invalidations == 1
    assert ex.stats.weight_misses == 2
    assert len(ex.weight_cache) == 1
    torch.testing.assert_close(out[1], tx[1] @ new_w, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(out[0], tx[0] @ tw[0], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("G,K,N,dtype,ok", [
    (4, 2048, 4096, torch.float32, True),       # the LSTM shape
    (4, 4096, 16384, torch.bfloat16, True),     # yi-9b decode envelope
    (3, 300, 32, torch.float32, True),          # any K, one fp32 tile
    (2, 128, 96, torch.bfloat16, False),        # N % 64 in bf16
    (2, 128, 100, torch.float32, False),        # N % 32 in fp32
    (2, 0, 128, torch.float32, False),
    (70000, 128, 128, torch.float32, False),    # grid z past 65535
    (2, 128, 128, torch.float16, False)])
def test_launch_guard(G, K, N, dtype, ok):
    """The guard passes the path's shapes and raises on what the kernel
    does not take; its geometry is the one the build hands nvcc."""
    for name in ("THREADS", "ROW_LANES", "UNROLL", "MAX_CLUSTER"):
        assert f"-DGV_{name}={getattr(gv, name)}" in gv.LIBRARY.flags
    if ok:
        cfg = gv.launch_config(G, K, N, dtype)
        assert cfg.cluster == gv.k_split(K, dtype)
        assert cfg.grid == (cfg.cluster, N // gv.tile_n(dtype), G)
        assert cfg.threads == gv.THREADS
    else:
        with pytest.raises(ValueError):
            gv.launch_config(G, K, N, dtype)


def test_wrapper_checks_shapes_and_devices():
    x = torch.zeros(2, 128)
    with pytest.raises(ValueError):        # w of another K
        gv.coalesced_gemv(x, torch.zeros(2, 64, 128))
    with pytest.raises(ValueError):        # no kernel for this device
        gv.coalesced_gemv(x.to("meta"), torch.zeros(2, 128, 128,
                                                    device="meta"))
