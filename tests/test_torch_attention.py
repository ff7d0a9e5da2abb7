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
    build hands nvcc. Shared memory depends on the dtype (the tiles are
    staged in it) and passes the 48 KB static limit at the path's shapes,
    so the launch raises the cap (dynamic shared memory)."""
    assert set(fa.HEAD_DIMS) >= {32, 64, 128, 256}
    for name in ("BLOCK_Q", "BLOCK_KV", "STAGES"):
        assert f"-DFA_{name}={getattr(fa, name)}" in fa.LIBRARY.flags
    assert fa.BLOCK_Q == 16 * fa.WARPS       # one 16-row MMA tile a warp
    if ok:
        cfg = fa.launch_config(BH, S, D, dtype)
        assert cfg.grid == (-(-S // fa.BLOCK_Q), BH)
        assert cfg.threads == 32 * fa.WARPS
        assert cfg.smem == fa.smem_bytes(D, dtype) <= fa.MAX_SMEM
    else:
        with pytest.raises(ValueError):
            fa.launch_config(BH, S, D, dtype)
    assert fa.BLOCK_KV % 16 == 0             # whole 16-key MMA steps
    for dt in fa.DTYPE_CODES:
        for d in fa.HEAD_DIMS:                   # every instance fits a block
            assert fa.smem_bytes(d, dt) <= fa.MAX_SMEM
        assert fa.smem_bytes(256, dt) > 48 * 1024
    # the tiles are staged in their own dtype: fp32 takes about twice bf16
    assert fa.smem_bytes(128, torch.float32) > fa.smem_bytes(128,
                                                            torch.bfloat16)


def test_wrapper_checks_shapes_and_devices():
    q = torch.zeros(2, 64, 32)
    with pytest.raises(ValueError):        # k of another S
        fa.flash_attention(q, torch.zeros(2, 32, 32), q)
    with pytest.raises(ValueError):        # negative window
        fa.flash_attention(q, q, q, window=-1)
    m = q.to("meta")
    with pytest.raises(ValueError):        # no kernel for this device
        fa.flash_attention(m, m, m)


# ---------------------------------------------------------------------------
# The numerical design of the card's kernel, emulated in plain torch.
#
# The CUDA kernel computes Q K^T and P V on tensor cores. In bf16, Q K^T
# loses nothing (a product of two bf16 values is exact in fp32, and the sum
# is fp32), but P V would need P rounded to bf16. In fp32 the tensor cores
# take TF32 (10-bit mantissas). These tests hold each choice against the
# limits the card's checks use (chip_smoke.py ATTN_TOL,
# tests/test_torch_cuda.py): bf16 rtol 1e-2 / atol 1e-4 (one bf16 ulp of
# outputs of order 1, with a floor for fp32 summation noise) and fp32
# rtol 2e-5 / atol 2e-4 (the attention tolerance of tests/test_kernels.py).
# The dense softmax stands in for the online one: both keep P in fp32, and
# how P V rounds is what decides the error.
# ---------------------------------------------------------------------------

CARD_TOL = {"bfloat16": (1e-2, 1e-4), "float32": (2e-5, 2e-4)}


def _causal_qkv(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(dtype) for _ in range(3)]


def _probs(logits):
    """Causal softmax in fp32 with the kernel's finite -2e38 fill."""
    S = logits.shape[-1]
    keep = torch.ones(S, S, dtype=torch.bool).tril()
    return torch.softmax(logits.masked_fill(~keep, -2.0e38), dim=-1)


def _outside(got, want, dtype):
    """How many outputs break the card's limit, and the largest error."""
    rtol, atol = CARD_TOL[dtype]
    err = (got.float() - want.float()).abs()
    return (int((err > atol + rtol * want.float().abs()).sum()),
            float(err.max()))


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10-bit mantissa), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds: add half of the dropped
    13 bits' weight to the bit pattern, then clear them."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _bf16_pv(p, v, split):
    """P V on bf16 tensor cores (exact products, fp32 sums): P rounded once
    to bf16, or split as P_hi + P_lo, both bf16, in two products."""
    p_hi = p.bfloat16().float()
    out = p_hi @ v.float()
    if split:
        out = out + (p - p_hi).bfloat16().float() @ v.float()
    return out.bfloat16()


def _tf32_mm(a, b, three):
    """a @ b on TF32 tensor cores: operands rounded once (plain TF32), or
    3xTF32 with RNA splitting: hi = rna(x), lo = rna(x - hi), and
    a_hi b_hi + a_hi b_lo + a_lo b_hi."""
    a_hi, b_hi = tf32_rna(a), tf32_rna(b)
    if not three:
        return a_hi @ b_hi
    a_lo, b_lo = tf32_rna(a - a_hi), tf32_rna(b - b_hi)
    return a_hi @ b_lo + a_lo @ b_hi + a_hi @ b_hi


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                       # exactly representable
    x = torch.tensor([one, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0e-3])
    got = tf32_rna(x)
    assert got[0] == one
    assert got[1] == one                         # a tie goes away from 0
    assert got[2] == 1.0 + 2 * 2.0 ** -10
    assert got[3] == -one
    assert got[4] == 1.0
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    assert abs(float(got[5]) - 3.0e-3) <= 3.0e-3 * 2.0 ** -11


@pytest.mark.parametrize("shape", [(8, 512, 128), (4, 1024, 256)])
def test_split_p_bf16_holds_card_limit(shape):
    """P = P_hi + P_lo (both bf16), two MMAs against the same V fragments:
    the residual of P is below 2^-16 of P, so the kernel's bf16 output is
    within one bf16 ulp of the dense fp32 softmax's."""
    q, k, v = _causal_qkv(shape, torch.bfloat16)
    want = flash_attention_ref(q, k, v, causal=True)
    p = _probs(q.float() @ k.float().transpose(1, 2) / shape[2] ** 0.5)
    n_out, err = _outside(_bf16_pv(p, v, split=True), want, "bfloat16")
    assert n_out == 0, (n_out, err)


@pytest.mark.parametrize("shape", [(8, 512, 128), (4, 1024, 256)])
def test_single_rounded_p_breaks_card_limit(shape):
    """Why the split exists: P rounded once to bf16 puts several percent
    of the outputs outside one bf16 ulp (2^-9 relative error in every
    weight, summed over hundreds of keys)."""
    q, k, v = _causal_qkv(shape, torch.bfloat16)
    want = flash_attention_ref(q, k, v, causal=True)
    p = _probs(q.float() @ k.float().transpose(1, 2) / shape[2] ** 0.5)
    n_out, err = _outside(_bf16_pv(p, v, split=False), want, "bfloat16")
    assert n_out > 0.01 * want.numel() and err > 1e-2, (n_out, err)


@pytest.mark.parametrize("three,holds", [(True, True), (False, False)])
def test_3xtf32_holds_fp32_limit_plain_tf32_does_not(three, holds):
    """fp32 inputs: Q K^T and P V both on TF32 tensor cores. 3xTF32 keeps
    about 21 bits of every product (the dropped a_lo b_lo term is 2^-22 of
    it) and holds the fp32 limit; plain TF32 keeps 11 and breaks it."""
    shape = (4, 512, 128)
    q, k, v = _causal_qkv(shape, torch.float32)
    want = flash_attention_ref(q, k, v, causal=True)
    logits = _tf32_mm(q, k.transpose(1, 2), three) / shape[2] ** 0.5
    got = _tf32_mm(_probs(logits), v, three)
    n_out, err = _outside(got, want, "float32")
    if holds:
        assert n_out == 0 and err < 1e-5, (n_out, err)
    else:
        assert n_out > 100 and err > 5e-4, (n_out, err)
