"""The port's MoE FFN (``repro_torch/models/moe.py``) against the JAX
package's ``models/moe.py``, on the CPU.

Weights come from the JAX package's ``init_moe`` and are carried across
with ``params_from_numpy``; tokens are drawn with numpy from a seed.
Routing bookkeeping must be exact: expert indices, the sort order, slots
and the keep mask. Weights, buffers and outputs are held within fp32 1e-6
(the router's softmax and matmul sum in other orders). One case per
routing test has a capacity factor small enough to drop tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.models import moe as jmoe
from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_numpy

TOL = dict(rtol=1e-6, atol=1e-6)
D, FF = 32, 64


def _setup(E, k, T, cf, seed=0):
    jcfg = JaxMoEConfig(num_experts=E, top_k=k, capacity_factor=cf)
    tcfg = MoEConfig(num_experts=E, top_k=k, capacity_factor=cf)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), D, FF, jcfg, jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    x = np.random.default_rng(seed).standard_normal((T, D)).astype(
        np.float32)
    return jcfg, tcfg, jp, tp, x


CASES = [  # (E, top_k, T, capacity_factor): the last of each E drops tokens
    (2, 2, 8, 1.25), (2, 1, 13, 0.25), (4, 2, 12, 1.25), (4, 2, 16, 0.25)]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("E,k,T,cf", CASES)
def test_route_matches_reference(E, k, T, cf):
    jcfg, tcfg, jp, tp, x = _setup(E, k, T, cf)
    jw, je, jaux = jmoe.route(jp["router"], jnp.asarray(x), jcfg)
    tw, te, taux = tmoe.route(tp["router"], torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    _close(tw, jw)
    _close(taux, jaux)


def test_route_breaks_ties_toward_the_lower_index():
    """All probabilities equal (a zero router): the JAX package's top_k
    picks experts 0..k-1, in order; so must the port."""
    cfg = MoEConfig(num_experts=4, top_k=2)
    x = torch.randn(5, D, generator=torch.Generator().manual_seed(1))
    w, e, _ = tmoe.route(torch.zeros(D, 4), x, cfg)
    _, je, _ = jmoe.route(jnp.zeros((D, 4)), jnp.asarray(x.numpy()),
                          JaxMoEConfig(num_experts=4, top_k=2))
    assert e.tolist() == [[0, 1]] * 5 == np.asarray(je).tolist()
    assert torch.equal(w, torch.full((5, 2), 0.5))


@pytest.mark.parametrize("E,k,T,cf", CASES)
def test_dispatch_and_combine_match_reference(E, k, T, cf):
    jcfg, tcfg, jp, tp, x = _setup(E, k, T, cf, seed=2)
    C = tmoe.capacity(T, tcfg)
    assert C == jmoe.capacity(T, jcfg)
    jw, je, _ = jmoe.route(jp["router"], jnp.asarray(x), jcfg)
    tw, te, _ = tmoe.route(tp["router"], torch.from_numpy(x), tcfg)
    jbuf, jmeta = jmoe.dispatch_tokens(jnp.asarray(x), jw, je, E, k, C)
    tbuf, tmeta = tmoe.dispatch_tokens(torch.from_numpy(x), tw, te, E, k, C)
    # order, sorted_e, sorted_tok, keep and slot: exact
    for got, want in zip(tmeta, jmeta):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    keep = tmeta[3].numpy()
    if cf < 1.0:
        assert not keep.all()          # this case drops assignments
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    # the same expert outputs through both combines
    out = np.random.default_rng(3).standard_normal((E, C, D)).astype(
        np.float32)
    jy = jmoe.combine_tokens(jnp.asarray(out), jw.reshape(-1), jmeta, T, D)
    ty = tmoe.combine_tokens(torch.from_numpy(out), tw.reshape(-1), tmeta,
                             T, D)
    assert ty.dtype == torch.float32
    _close(ty, jy)


def test_capacity_truncates_and_floors_as_the_reference():
    for T in (1, 3, 4, 7, 32):
        for E, k, cf in ((8, 2, 1.25), (4, 2, 0.25), (2, 1, 1.0)):
            assert tmoe.capacity(T, MoEConfig(E, k, cf)) == \
                jmoe.capacity(T, JaxMoEConfig(E, k, cf)), (T, E, k, cf)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("E,k,T,cf", [(4, 2, 16, 1.25), (4, 2, 16, 0.5),
                                      (2, 1, 12, 8.0)])
def test_moe_ffn_matches_reference(E, k, T, cf, groups):
    jcfg, tcfg, jp, tp, x = _setup(E, k, T, cf, seed=4)
    jy, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg, groups=groups)
    ty, taux = tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg, groups=groups)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    _close(taux, jaux)


def test_moe_ffn_indivisible_groups_fall_back_to_one():
    _, tcfg, _, tp, x = _setup(2, 1, 10, 8.0, seed=5)
    y4, _ = tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg, groups=4)
    y1, _ = tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg, groups=1)
    assert torch.equal(y4, y1)


def test_expert_ffn_weights_are_the_stacked_slices():
    _, _, _, tp, _ = _setup(4, 2, 8, 1.25)
    for e in range(4):
        wg, wu, wd = tmoe.expert_ffn_weights(tp, e)
        assert torch.equal(wg, tp["w_gate"][e])
        assert torch.equal(wu, tp["w_up"][e])
        assert torch.equal(wd, tp["w_down"][e])
