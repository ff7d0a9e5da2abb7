"""The port's superkernel layer against the JAX package's, on the CPU.

The plain PyTorch ``coalesced_gemm`` (what the wrapper runs on a CPU
tensor) is held against the Pallas kernel in interpret mode on ragged
groups; the packer, the eager superkernel path and the dispatch executor
against theirs. Inputs are made with numpy from a seed and handed to both.
Tolerances: fp32 2e-4 (the GEMM tolerance of tests/test_kernels.py: both
sides accumulate in fp32, in different orders); bf16 8e-2 relative with an
8x absolute floor, as tests/test_kernels.py states for bf16 (one bf16 ulp
of the output is 2^-8 relative).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.costmodel import GemmShape as JaxGemmShape
from repro.core.dispatch import SuperkernelExecutor as JaxExecutor
from repro.core.kernelspec import make_op as jax_make_op
from repro.core.plancache import PlanCache as JaxPlanCache
from repro.kernels import ops as jax_ops
from repro.kernels.coalesced_gemm import coalesced_gemm as jax_gemm
from repro_torch.core.costmodel import GemmShape
from repro_torch.core.dispatch import SuperkernelExecutor
from repro_torch.core.kernelspec import make_op
from repro_torch.core.plancache import PlanCache
from repro_torch.kernels import ops

# the module (the package re-exports the function under the same name)
cg = importlib.import_module("repro_torch.kernels.coalesced_gemm")

TOL = {"float32": (2e-4, 2e-4), "bfloat16": (8e-2, 8 * 8e-2)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a CPU tensor of ``dtype``."""
    return (jnp.asarray(x).astype(JNP[dtype]),
            torch.from_numpy(x).to(TORCH[dtype]))


def _close(got: torch.Tensor, want, dtype: str):
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def _ragged(rows, K, N, pad_tiles, seed, bm=8):
    """A packed ragged group: per-problem rows padded to ``bm``, then
    ``pad_tiles`` all-zero m-tiles that point at group 0."""
    G = len(rows)
    parts, gids = [], []
    for g, m in enumerate(rows):
        m_pad = -(-m // bm) * bm
        a = np.zeros((m_pad, K), np.float32)
        a[:m] = _np((m, K), seed + g)
        parts.append(a)
        gids += [g] * (m_pad // bm)
    parts.append(np.zeros((pad_tiles * bm, K), np.float32))
    gids += [0] * pad_tiles
    return (np.concatenate(parts), _np((G, K, N), seed + 100),
            np.asarray(gids, np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,pad_tiles", [
    ([5], 1), ([3, 17, 8], 2), ([1, 9, 30, 4], 3)])
def test_plain_coalesced_gemm_matches_pallas(rows, pad_tiles, dtype):
    a, b, gid = _ragged(rows, K=256, N=384, pad_tiles=pad_tiles, seed=7)
    ja, ta = _both(a, dtype)
    jb, tb = _both(b, dtype)
    want = jax_gemm(ja, jb, jnp.asarray(gid), bm=8, bn=128, bk=128,
                    interpret=True)
    got = cg.coalesced_gemm(ta, tb, torch.from_numpy(gid), bm=8)
    assert got.dtype == TORCH[dtype] and tuple(got.shape) == a.shape[:1] + (384,)
    _close(got, np.asarray(want, np.float32), dtype)
    # pad rows come back zero
    m_real = sum(-(-m // 8) * 8 for m in rows)
    assert torch.count_nonzero(got[m_real:]) == 0


def test_wrapper_checks_shapes_and_devices():
    a = torch.zeros(16, 128)
    b = torch.zeros(2, 128, 128)
    with pytest.raises(ValueError):       # group_ids of the wrong length
        cg.coalesced_gemm(a, b, torch.zeros(3, dtype=torch.int32), bm=8)
    with pytest.raises(ValueError):       # no kernel for this device
        cg.coalesced_gemm(a.to("meta"), b.to("meta"),
                          torch.zeros(2, dtype=torch.int32, device="meta"),
                          bm=8)


@pytest.mark.parametrize("M,K,N,bm,ok", [
    (8, 4096, 16384, 8, True), (16, 16384, 4096, 8, True),
    (8, 128, 100, 8, False), (8, 128, 128, 4, False),
    (12, 128, 128, 8, False)])
def test_launch_guard(M, K, N, bm, ok):
    """The guard that replaces the TPU VMEM check raises on what the CUDA
    kernel would refuse and passes the main path's shapes; its geometry is
    the one the build hands nvcc: a grid of (K split, column tiles, groups)
    with the K split as the cluster, and the ring's shared memory."""
    for name in ("ROWS", "BLOCK_N", "THREADS", "STAGES", "TILE_BYTES",
                 "PASS_CHUNKS", "MAX_CLUSTER"):
        assert f"-DCG_{name}={getattr(cg, name)}" in cg.LIBRARY.flags
    for dtype in (torch.float32, torch.bfloat16):
        if ok:
            cfg = cg.launch_config(M, K, N, bm, 2, dtype)
            cluster, per_rank = cg.k_split(K, dtype)
            assert cfg.grid == (cluster, N // cg.BLOCK_N, 2)
            assert cfg.cluster == cluster and cfg.tiles_per_rank == per_rank
            assert 1 <= cluster <= cg.MAX_CLUSTER
            assert cfg.threads == cg.THREADS
            assert cfg.smem == cg.smem_bytes(dtype) <= cg.MAX_SMEM
        else:
            with pytest.raises(ValueError):
                cg.launch_config(M, K, N, bm, 2, dtype)


def test_envelope_bucket_and_round_up_match():
    for x in range(1, 2100):
        assert ops.envelope_bucket(x) == jax_ops.envelope_bucket(x)
        assert ops.envelope_bucket(x, minimum=8) == \
            jax_ops.envelope_bucket(x, minimum=8)
        assert ops._round_up(x, 128) == jax_ops._round_up(x, 128)


def _problems(shapes, dtype, seed=0):
    jp, tp = [], []
    for i, (m, k, n) in enumerate(shapes):
        ja, ta = _both(_np((m, k), seed + 2 * i), dtype)
        jb, tb = _both(_np((k, n), seed + 2 * i + 1), dtype)
        jp.append((ja, jb))
        tp.append((ta, tb))
    return jp, tp


SHAPES = [(100, 256, 384), (64, 200, 384), (17, 256, 300)]


def test_pack_problems_matches():
    jp, tp = _problems(SHAPES, "float32")
    want = jax_ops.pack_problems(jp, bm=8)
    got = ops.pack_problems(tp, bm=8)
    np.testing.assert_array_equal(got.a_packed.numpy(),
                                  np.asarray(want.a_packed))
    np.testing.assert_array_equal(got.b_stacked.numpy(),
                                  np.asarray(want.b_stacked))
    np.testing.assert_array_equal(got.group_ids.numpy(),
                                  np.asarray(want.group_ids))
    assert got.row_slices == want.row_slices and got.n_real == want.n_real


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared", [False, True])
def test_execute_superkernel_matches(shared, dtype):
    shapes = [(m, 256, 384) for m in (5, 12, 1)] if shared else SHAPES
    jp, tp = _problems(shapes, dtype)
    if shared:      # one weight matrix for every problem
        jp = [(a, jp[0][1]) for a, _ in jp]
        tp = [(a, tp[0][1]) for a, _ in tp]
    want = jax_ops.execute_superkernel(jp, bm=8, bn=128, bk=128,
                                       shared_operand=shared)
    got = ops.execute_superkernel(tp, bm=8, shared_operand=shared)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, np.asarray(w, np.float32), dtype)


def _op_pairs(jp, tp, keys):
    """The same declared ops in both packages, payloads bound."""
    jops, tops = [], []
    for i, ((ja, jb), (ta, tb), key) in enumerate(zip(jp, tp, keys)):
        m, k = ja.shape
        n = jb.shape[1]
        jo = jax_make_op(i, "gemm", JaxGemmShape(m=m, n=n, k=k), tag="t",
                         seq_index=0)
        jo.payload = (ja, jb, key)
        to = make_op(i, "gemm", GemmShape(m=m, n=n, k=k), tag="t",
                     seq_index=0)
        to.payload = (ta, tb, key)
        jops.append(jo)
        tops.append(to)
    return jops, tops


@pytest.mark.parametrize("shared", [False, True])
def test_executor_matches_and_counts(shared):
    """SuperkernelExecutor on the same op groups: same outputs (2e-4) and
    the same packed-weight cache accounting; ``retraces`` (kernel builds
    here) stays 0 on the CPU."""
    shapes = [(4, 128, 256)] * 3 if shared else \
        [(5, 300, 200), (11, 260, 190), (4, 128, 256)]
    jp, tp = _problems(shapes, "float32", seed=3)
    if shared:
        jp = [(a, jp[0][1]) for a, _ in jp]
        tp = [(a, tp[0][1]) for a, _ in tp]
        keys = [("shared-w",)] * 3
    else:
        keys = [("w", i) for i in range(3)]
    jops, tops = _op_pairs(jp, tp, keys)
    jex = JaxExecutor(JaxPlanCache(32), bm=8)
    tex = SuperkernelExecutor(PlanCache(32), bm=8)
    for _ in range(3):
        want = jex.execute(jops, shared_operand=shared)
        got = tex.execute(tops, shared_operand=shared)
        for g, w in zip(got, want):
            assert tuple(g.shape) == tuple(w.shape)
            _close(g, np.asarray(w), "float32")
    for f in ("dispatches", "weight_hits", "weight_misses",
              "weight_invalidations", "bytes_not_copied"):
        assert getattr(tex.stats, f) == getattr(jex.stats, f), f
    assert tex.stats.retraces == 0
    assert tex.stats.weight_hit_rate == pytest.approx(2 / 3)


def test_executor_hot_swap_by_replacement():
    """A hot-swap replaces the weight tensor (same key, new object): the
    identity guard trips and the output follows the new weights."""
    a = torch.from_numpy(_np((4, 128), 0))
    old_w = torch.from_numpy(_np((128, 128), 1))
    new_w = torch.from_numpy(_np((128, 128), 2))
    ex = SuperkernelExecutor(PlanCache(32), bm=8)
    key = [("tenant", 0, "ffn")]
    ex.execute_problems([(a, old_w)], key)
    out = ex.execute_problems([(a, new_w)], key)[0]
    assert ex.stats.weight_invalidations == 1
    torch.testing.assert_close(out, a @ new_w, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name,entry", [
    ("coalesced_gemm", "coalesced_gemm_launch"),
    ("coalesced_gemv", "coalesced_gemv_launch"),
    ("flash_attention", "flash_attention_launch")])
def test_kernel_source_and_build_are_lazy(name, entry):
    """Each CUDA source ships beside its wrapper, is built for sm_90a by the
    one shared loader, and importing the wrapper builds nothing (there is no
    nvcc on a CPU host)."""
    from repro_torch.kernels import build
    mod = importlib.import_module(f"repro_torch.kernels.{name}")
    source = mod.LIBRARY.source
    assert source.exists() and source.suffix == ".cu"
    assert source.parent == build.CSRC and source.stem == name
    text = source.read_text()
    assert "extern \"C\"" in text and "int64_t" in text
    assert f"{name}_error_string" in text and entry in text
    assert entry in dict(mod.LIBRARY.entry_points)
    assert "sm_90a" in " ".join(mod.LIBRARY.flags)
    assert mod.LIBRARY.flags[:len(build.NVCC_FLAGS)] == build.NVCC_FLAGS
    assert build.build_count() == 0
    assert mod.LIBRARY.path().parent == build.BUILD_DIR
