"""The port's flash attention against the JAX package's, on the CPU.

The plain PyTorch ``flash_attention`` (what the wrapper runs on a CPU
tensor) is held against the Pallas kernel in interpret mode on [BH, S, D],
``ops.windowed_attention`` against the JAX entry point on [B, H, S, D].
Inputs are made with numpy from a seed and handed to both. Tolerances are
those of tests/test_kernels.py: fp32 2e-5 relative, bf16 2e-2 relative,
each with a 10x absolute floor (the Pallas kernel's online softmax and the
plain dense softmax add in different orders).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref

# the module (the package re-exports the function under the same name)
fa = importlib.import_module("repro_torch.kernels.flash_attention")

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(shape, dtype, seed=0):
    """q, k, v of ``shape`` as JAX arrays and as CPU tensors of ``dtype``."""
    out = []
    for i in range(3):
        x = np.random.default_rng(seed + i).standard_normal(shape).astype(
            np.float32)
        out.append((jnp.asarray(x).astype(JNP[dtype]),
                    torch.from_numpy(x).to(TORCH[dtype])))
    return [j for j, _ in out], [t for _, t in out]


def _close(got: torch.Tensor, want, dtype: str):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol * 10)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [256, 48])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_attention_matches_pallas(causal, window, S, dtype):
    """[BH, S, D] with S a multiple of the Pallas tile (256) and below it
    (48, which the CUDA kernel masks as a ragged tile)."""
    jq, tq = _qkv((3, S, 32), dtype, seed=S + window)
    want = jax_flash(*jq, causal=causal, window=window, interpret=True)
    got = fa.flash_attention(*tq, causal=causal, window=window)
    assert got.dtype == TORCH[dtype] and tuple(got.shape) == (3, S, 32)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64),
                                           (False, 0)])
def test_windowed_attention_matches(causal, window, dtype):
    jq, tq = _qkv((2, 3, 256, 64), dtype, seed=11)
    want = jax_ops.windowed_attention(*jq, causal=causal, window=window,
                                      interpret=True)
    got = ops.windowed_attention(*tq, causal=causal, window=window)
    assert tuple(got.shape) == (2, 3, 256, 64)
    _close(got, want, dtype)


def test_plain_version_matches_jax_dense_oracle():
    """The plain version on [BH, S, D] is the JAX dense oracle on
    [B, H, S, D] with B x H flattened."""
    jq, tq = _qkv((2, 2, 96, 64), "float32", seed=21)
    want = jax_ref.flash_attention_ref(*jq, causal=True, window=40)
    got = flash_attention_ref(*(t.reshape(4, 96, 64) for t in tq),
                              causal=True, window=40)
    _close(got.reshape(2, 2, 96, 64), want, "float32")


@pytest.mark.parametrize("BH,S,D,dtype,ok", [
    (32, 4096, 128, torch.float32, True),     # yi-9b global
    (4, 4096, 256, torch.bfloat16, True),     # gemma3-1b local
    (3, 48, 32, torch.float32, True),         # S below one tile
    (2, 1, 64, torch.bfloat16, True),
    (2, 128, 48, torch.float32, False),       # head dim not compiled
    (2, 128, 512, torch.float32, False),
    (2, 0, 64, torch.float32, False),
    (70000, 128, 64, torch.float32, False),   # grid y past 65535
    (2, 128, 64, torch.float16, False)])
def test_launch_guard(BH, S, D, dtype, ok):
    """The guard names the head dims it takes, passes the path's shapes and
    raises on what the kernel does not take; its geometry is the one the
    build hands nvcc. At D = 256 a block needs more than the 48 KB of static
    shared memory, so the launch raises the cap (dynamic shared memory)."""
    assert set(fa.HEAD_DIMS) >= {32, 64, 128, 256}
    assert f"-DFA_BLOCK_Q={fa.BLOCK_Q}" in fa.LIBRARY.flags
    assert f"-DFA_BLOCK_KV={fa.BLOCK_KV}" in fa.LIBRARY.flags
    if ok:
        cfg = fa.launch_config(BH, S, D, dtype)
        assert cfg.grid == (-(-S // fa.BLOCK_Q), BH)
        assert cfg.smem == fa.smem_bytes(D) <= fa.MAX_SMEM
    else:
        with pytest.raises(ValueError):
            fa.launch_config(BH, S, D, dtype)
    assert fa.smem_bytes(256) > 48 * 1024


def test_wrapper_checks_shapes_and_devices():
    q = torch.zeros(2, 64, 32)
    with pytest.raises(ValueError):        # k of another S
        fa.flash_attention(q, torch.zeros(2, 32, 32), q)
    with pytest.raises(ValueError):        # negative window
        fa.flash_attention(q, q, q, window=-1)
    m = q.to("meta")
    with pytest.raises(ValueError):        # no kernel for this device
        fa.flash_attention(m, m, m)
