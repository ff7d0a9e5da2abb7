"""The port's Mamba-2 block (``repro_torch/models/ssm.py``) against the JAX
package's ``models/ssm.py``, on the CPU, at the mamba2-2.7b smoke widths
(d_model 128, d_state 16, head_dim 32, chunk 16).

Weights come from the JAX package's ``init_mamba`` and are carried across
with ``params_from_numpy``; inputs and caches are drawn with numpy from a
seed. Tolerances (fp32): 1e-5 for the decode path (``decode_core``,
``ssd_decode_step``), 1e-4 for the chunked path (``ssd_chunked``, whose
einsums and chunk recurrence sum in other orders), at S = 5 (one padded
chunk) and S = 21 (two chunks, the second padded) as well as a whole
chunk. The port's ``ssd_chunked`` is also held against its own
step-by-step ``ssd_reference``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import ssm as jssm
from repro_torch.configs import smoke_config
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import params_from_numpy

DEC = dict(rtol=1e-5, atol=1e-5)
CHUNK = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def block():
    jcfg = jax_smoke_config("mamba2-2.7b")
    tcfg = smoke_config("mamba2-2.7b")
    jp = jssm.init_mamba(jax.random.PRNGKey(3), jcfg.d_model, jcfg.ssm,
                         jnp.float32)
    # a nonzero conv bias and norm, so both enter the comparison
    rng = np.random.default_rng(9)
    jp = dict(jp, conv_b=jnp.asarray(
        0.1 * rng.standard_normal(jp["conv_b"].shape), jnp.float32),
              norm=jnp.asarray(0.1 * rng.standard_normal(jp["norm"].shape),
                               jnp.float32))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jcfg, tcfg, jp, tp


def _cache(cfg, B, seed):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    rng = np.random.default_rng(seed)
    conv = rng.standard_normal((B, s.d_conv - 1, d_inner + 2 * s.d_state))
    h = 0.1 * rng.standard_normal((B, s.num_heads(cfg.d_model), s.head_dim,
                                   s.d_state))
    return conv.astype(np.float32), h.astype(np.float32)


def _pair(conv, h):
    return ({"conv": jnp.asarray(conv), "h": jnp.asarray(h)},
            {"conv": torch.from_numpy(conv), "h": torch.from_numpy(h)})


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("B", [1, 3])
def test_decode_core_matches_reference(block, B):
    jcfg, tcfg, jp, tp = block
    s = tcfg.ssm
    n_in = 2 * s.expand * tcfg.d_model + 2 * s.d_state \
        + s.num_heads(tcfg.d_model)
    zx = np.random.default_rng(B).standard_normal((B, n_in)).astype(
        np.float32)
    jc, tc = _pair(*_cache(tcfg, B, seed=B + 10))
    jy, jnew = jssm.decode_core(jp, jnp.asarray(zx), jc, jcfg.ssm,
                                jcfg.d_model)
    ty, tnew = tssm.decode_core(tp, torch.from_numpy(zx), tc, tcfg.ssm,
                                tcfg.d_model)
    _close(ty, jy, DEC)
    for k in ("conv", "h"):
        _close(tnew[k], jnew[k], DEC)
        assert tnew[k].dtype == tc[k].dtype


def test_ssd_decode_step_matches_reference(block):
    jcfg, tcfg, jp, tp = block
    B = 2
    u = np.random.default_rng(1).standard_normal(
        (B, 1, tcfg.d_model)).astype(np.float32)
    jc, tc = _pair(*_cache(tcfg, B, seed=4))
    for _ in range(3):     # three steps, each from the last step's cache
        jy, jc = jssm.ssd_decode_step(jp, jnp.asarray(u), jc, jcfg.ssm)
        ty, tc = tssm.ssd_decode_step(tp, torch.from_numpy(u), tc, tcfg.ssm)
        _close(ty, jy, DEC)
        for k in ("conv", "h"):
            _close(tc[k], jc[k], DEC)
        u = np.array(jy)


@pytest.mark.parametrize("S", [5, 16, 21])
def test_ssd_chunked_matches_reference(block, S):
    jcfg, tcfg, jp, tp = block
    u = np.random.default_rng(S).standard_normal(
        (2, S, tcfg.d_model)).astype(np.float32)
    jy, jst = jssm.ssd_chunked(jp, jnp.asarray(u), jcfg.ssm,
                               return_state=True)
    ty, tst = tssm.ssd_chunked(tp, torch.from_numpy(u), tcfg.ssm,
                               return_state=True)
    assert tuple(ty.shape) == (2, S, tcfg.d_model)
    _close(ty, jy, CHUNK)
    for k in ("conv", "h"):
        _close(tst[k], jst[k], CHUNK)
    assert tst["h"].dtype == torch.float32


@pytest.mark.parametrize("S", [5, 21])
def test_ssd_chunked_matches_own_recurrence(block, S):
    """The chunked (dual) form against the port's step-by-step oracle,
    including the state the serving prefill hands to decode."""
    _, tcfg, _, tp = block
    u = torch.from_numpy(np.random.default_rng(S + 1).standard_normal(
        (2, S, tcfg.d_model)).astype(np.float32))
    y, st = tssm.ssd_chunked(tp, u, tcfg.ssm, return_state=True)
    torch.testing.assert_close(y, tssm.ssd_reference(tp, u, tcfg.ssm),
                               **CHUNK)
    cache = tssm.init_ssm_cache(2, tcfg.d_model, tcfg.ssm, u.dtype, u.device)
    for t in range(S):
        _, cache = tssm.ssd_decode_step(tp, u[:, t:t + 1], cache, tcfg.ssm)
    for k in ("conv", "h"):
        torch.testing.assert_close(st[k], cache[k], **CHUNK)


def test_ssd_chunked_refuses_a_prompt_shorter_than_the_conv_window(block):
    _, tcfg, _, tp = block
    u = torch.zeros(1, tcfg.ssm.d_conv - 2, tcfg.d_model)
    with pytest.raises(AssertionError):
        tssm.ssd_chunked(tp, u, tcfg.ssm, return_state=True)


def test_softplus_is_logaddexp_past_torch_threshold():
    """``jax.nn.softplus`` is logaddexp(x, 0) everywhere; torch's
    ``F.softplus`` returns x above 20. The port follows the JAX package."""
    x = np.array([-40.0, -30.0, -1.0, 0.0, 3.0, 19.0, 20.5, 25.0, 60.0],
                 np.float32)
    got = tssm.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.nn.softplus(x)))


def test_init_mamba_tree_matches_reference(block):
    jcfg, tcfg, jp, _ = block
    own = tssm.init_mamba(2, tcfg.d_model, tcfg.ssm, torch.bfloat16,
                          torch.device("cpu"), torch.Generator().manual_seed(0))
    ref = jssm.init_mamba(jax.random.PRNGKey(0), jcfg.d_model, jcfg.ssm,
                          jnp.bfloat16)
    assert sorted(own) == sorted(ref)
    for k in ref:
        assert tuple(own[k].shape) == (2,) + tuple(ref[k].shape), k
        assert str(own[k].dtype).removeprefix("torch.") == \
            jnp.dtype(ref[k].dtype).name, k
    # softplus(dt_bias) spans [1e-3, 1e-1], as the reference initialises it
    dt = tssm.softplus(own["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)
