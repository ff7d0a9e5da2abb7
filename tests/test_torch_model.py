"""The port's dense Model against the JAX package's, on the CPU.

Weights are made once by the JAX package and carried across by
``models/convert.py``; prompts and decode tokens are made with numpy from a
seed. ``prefill`` and ``decode_step`` logits and every cache leaf must agree
at 2e-4 in fp32 (both sides compute in fp32; the sums run in different
orders). yi-9b smoke is the plain GQA stack; gemma3-1b smoke brings the
local/global window alternation (prompt longer than its 32-token window)
and the tied unembed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import Model as JaxModel
from repro_torch.configs import smoke_config
from repro_torch.models import Model
from repro_torch.models.convert import params_from_numpy

TOL = dict(rtol=2e-4, atol=2e-4)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _pair(arch, seed=0):
    jm = JaxModel(jax_smoke_config(arch), param_dtype=jnp.float32)
    jparams = jm.init(jax.random.PRNGKey(seed))
    tm = Model(smoke_config(arch), param_dtype=torch.float32, device="cpu")
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jm, jparams, tm, tparams


def _cache_close(got, want):
    assert set(got["layers"]) == set(want["layers"])
    for k in want["layers"]:
        _close(got["layers"][k].numpy(), want["layers"][k])
    np.testing.assert_array_equal(got["pos"].numpy(), np.asarray(want["pos"]))


def test_configs_are_copies():
    from repro.configs import REGISTRY as JR
    from repro_torch.configs import REGISTRY as TR
    assert sorted(JR) == sorted(TR)
    for name in JR:
        assert dataclasses.asdict(TR[name]) == dataclasses.asdict(JR[name])
        assert dataclasses.asdict(smoke_config(name)) == \
            dataclasses.asdict(jax_smoke_config(name))


def test_params_carried_across_exactly():
    jm, jparams, tm, tparams = _pair("gemma3-1b")
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    assert "unembed" not in tparams                      # tied embeddings
    for path, leaf in flat_j:
        node = tparams
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == tuple(leaf.shape)
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_init_shapes_match_reference_layout():
    """The port's own ``init`` (random, from a torch.Generator) builds the
    same tree and [L, ...] layout as the JAX package's."""
    jm, jparams, tm, _ = _pair("yi-9b")
    own = tm.init(torch.Generator().manual_seed(0))
    want = jax.tree_util.tree_map(lambda a: tuple(a.shape), jparams)
    got = jax.tree_util.tree_map(lambda a: tuple(a.shape), own)
    assert got == want


@pytest.mark.parametrize("arch,S,CL", [("yi-9b", 12, 32),
                                       ("gemma3-1b", 40, 64)])
def test_prefill_and_decode_match_reference(arch, S, CL):
    jm, jparams, tm, tparams = _pair(arch, seed=1)
    B = 2
    rng = np.random.default_rng(5)
    V = tm.cfg.vocab_size
    prompt = rng.integers(0, V, (B, S)).astype(np.int32)
    jlog, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(prompt)},
                              cache_len=CL)
    tlog, tcache = tm.prefill(tparams,
                              {"tokens": torch.from_numpy(prompt).long()},
                              cache_len=CL)
    _close(tlog.numpy(), jlog)
    _cache_close(tcache, jcache)
    for step in range(3):
        tok = rng.integers(0, V, (B, 1)).astype(np.int32)
        jlog, jcache = jm.decode_step(jparams, jnp.asarray(tok), jcache)
        tlog, tcache = tm.decode_step(tparams, torch.from_numpy(tok).long(),
                                      tcache)
        _close(tlog.numpy(), jlog)
        _cache_close(tcache, jcache)


def test_decode_leaves_input_cache_unchanged():
    """KV updates are functional: the bound cache keeps its values."""
    _, _, tm, tparams = _pair("yi-9b")
    cache = tm.init_cache(2, 16)
    before = {k: v.clone() for k, v in cache["layers"].items()}
    _, new = tm.decode_step(tparams, torch.ones(2, 1, dtype=torch.long),
                            cache)
    for k in before:
        assert torch.equal(cache["layers"][k], before[k])
        assert not torch.equal(new["layers"][k], before[k])


def test_cache_longer_than_rope_table_raises():
    tm = Model(smoke_config("yi-9b"), param_dtype=torch.float32,
               device="cpu")
    with pytest.raises(ValueError, match="rope table"):
        tm.init_cache(1, 8193)
