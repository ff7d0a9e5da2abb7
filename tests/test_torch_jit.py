"""The port's JIT templates against the JAX package's, on the CPU.

Decode and prefill programs are built from the same weights (carried
across by ``models/convert.py``) and inputs (numpy, from a seed) in both
packages, run through ``VLIWJit``, and compared: logits and every cache leaf
at 2e-4 in fp32, as tests/test_jit_engine.py holds its programs. The JAX side
runs its Pallas kernel in interpret mode. Decode runs in both regimes
(``stacked`` False and True, the same on both sides); the tests that
inspect per-layer ``GemmStage``s pin ``stacked=False``. The layer-stacked
regime's own tests are in tests/test_torch_stacked.py. Both JITs use the
same cost model, so their scheduling statistics must agree exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core import jit as jjit
from repro.core.costmodel import CostModel as JaxCostModel, TPUV5E as JTPU
from repro.models import Model as JaxModel
from repro_torch.configs import smoke_config
from repro_torch.core import jit as tjit
from repro_torch.core.costmodel import CostModel, TPUV5E
from repro_torch.models import Model
from repro_torch.models.convert import params_from_numpy

TOL = dict(rtol=2e-4, atol=2e-4)


def _setup(arch, seed=0, B=2, S=12, CL=32):
    jm = JaxModel(jax_smoke_config(arch), param_dtype=jnp.float32)
    jparams = jm.init(jax.random.PRNGKey(seed))
    tm = Model(smoke_config(arch), param_dtype=torch.float32, device="cpu")
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    rng = np.random.default_rng(seed + 11)
    V = tm.cfg.vocab_size
    prompt = rng.integers(0, V, (B, S)).astype(np.int32)
    tok = rng.integers(0, V, (B, 1)).astype(np.int32)
    _, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(prompt)},
                           cache_len=CL)
    _, tcache = tm.prefill(tparams,
                           {"tokens": torch.from_numpy(prompt).long()},
                           cache_len=CL)
    return (jm, jparams, jcache, jnp.asarray(tok),
            tm, tparams, tcache, torch.from_numpy(tok).long())


def _jits():
    return (jjit.VLIWJit(JaxCostModel(JTPU), max_group=8),
            tjit.VLIWJit(CostModel(TPUV5E), max_group=8))


def _same_stats(ts, js):
    assert ts.superkernels == js.superkernels
    assert ts.ops_executed == js.ops_executed
    assert ts.shared_dispatches == js.shared_dispatches
    assert ts.mean_group == pytest.approx(js.mean_group)
    assert ts.modeled_time_s == pytest.approx(js.modeled_time_s)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("arch", ["yi-9b", "gemma3-1b"])
def test_decode_template_matches_reference(arch, stacked):
    jm, jp, jc, jt, tm, tp, tc, tt = _setup(arch)
    jprog = jjit.build_dense_decode_template(
        jm, jp, 2, stacked=stacked).bind(stream_id=0, tokens=jt, cache=jc)
    tprog = tjit.build_dense_decode_template(
        tm, tp, 2, stacked=stacked).bind(stream_id=0, tokens=tt, cache=tc)
    jx, tx = _jits()
    js, ts = jx.run([jprog]), tx.run([tprog])
    _close(tprog.env["logits"], jprog.env["logits"])
    for k in ("k", "v"):
        _close(tprog.env["cache"]["layers"][k],
               jprog.env["cache"]["layers"][k])
    np.testing.assert_array_equal(tprog.env["cache"]["pos"].numpy(),
                                  np.asarray(jprog.env["cache"]["pos"]))
    _same_stats(ts, js)
    # the port's own monolithic decode agrees with its program
    want, _ = tm.decode_step(tp, tt, tc)
    torch.testing.assert_close(tprog.env["logits"], want[:, 0], **TOL)


@pytest.mark.parametrize("arch,S", [("yi-9b", 20), ("gemma3-1b", 40)])
def test_prefill_template_matches_reference(arch, S):
    """Prompt pass into slot 1 of a 2-row cache; the bucket pads the
    prompt (20 -> 32, 40 -> 64 past gemma3's 32-token window)."""
    CL = 64
    jm, jp, jc, _, tm, tp, tc, _ = _setup(arch, B=2, S=4, CL=CL)
    prompt = np.random.default_rng(3).integers(
        0, tm.cfg.vocab_size, (1, S)).astype(np.int32)
    Sp = tjit.prefill_bucket(S)
    assert Sp == jjit.prefill_bucket(S)
    padded = np.pad(prompt, ((0, 0), (0, Sp - S)))
    extra = {"real_len": S, "slot": 1}
    jprog = jjit.build_dense_prefill_template(jm, jp, Sp, stacked=False).bind(
        stream_id=0, tokens=jnp.asarray(padded), cache=jc, env_extra=extra)
    tprog = tjit.build_dense_prefill_template(tm, tp, Sp,
                                              stacked=False).bind(
        stream_id=0, tokens=torch.from_numpy(padded).long(), cache=tc,
        env_extra=dict(extra))
    before = {k: v.clone() for k, v in tc["layers"].items()}
    jx, tx = _jits()
    js, ts = jx.run([jprog]), tx.run([tprog])
    _close(tprog.env["logits"], jprog.env["logits"])
    for k in ("k", "v"):
        _close(tprog.env["cache"]["layers"][k],
               jprog.env["cache"]["layers"][k])
        # the bound cache is left as it was (functional epilogue)
        assert torch.equal(tc["layers"][k], before[k])
    np.testing.assert_array_equal(tprog.env["cache"]["pos"].numpy(),
                                  np.asarray(jprog.env["cache"]["pos"]))
    _same_stats(ts, js)
    # and the logits equal the port's own Model.prefill of the prompt
    want, _ = tm.prefill(tp, {"tokens": torch.from_numpy(prompt).long()},
                         cache_len=CL)
    torch.testing.assert_close(tprog.env["logits"], want[:, 0], **TOL)


def test_same_model_streams_share_weights():
    """Three lockstep streams of one params tree coalesce with operand
    sharing. The JAX package's per-layer regime needs the three programs
    bound from ONE template (it slices fresh per-layer views per template,
    and two templates' views trip its shared-operand identity check); the
    port memoizes its views, so three separately built templates share
    too — and give the same statistics."""
    jm, jp, jc, jt, tm, tp, tc, tt = _setup("gemma3-1b")
    jtpl = jjit.build_dense_decode_template(jm, jp, 2, stacked=False)
    jprogs = [jtpl.bind(stream_id=i, tokens=jt, cache=jc) for i in range(3)]
    tprogs = [tjit.build_dense_decode_template(tm, tp, 2, stacked=False)
              .bind(stream_id=i, tokens=tt, cache=tc) for i in range(3)]
    jx, tx = _jits()
    js, ts = jx.run(jprogs), tx.run(tprogs)
    for stats in (js, ts):
        assert stats.shared_dispatches == stats.superkernels
        assert stats.mean_group == pytest.approx(3.0)
    _same_stats(ts, js)
    for tprog, jprog in zip(tprogs, jprogs):
        _close(tprog.env["logits"], jprog.env["logits"])


def test_cross_model_groups_coalesce_without_sharing():
    jm1, jp1, jc1, jt1, tm1, tp1, tc1, tt1 = _setup("gemma3-1b")
    jm2, jp2, jc2, jt2, tm2, tp2, tc2, tt2 = _setup("yi-9b", seed=1)
    jprogs = [
        jjit.build_dense_decode_template(jm1, jp1, 2, stacked=False).bind(
            stream_id=0, tokens=jt1, cache=jc1),
        jjit.build_dense_decode_template(jm2, jp2, 2, stacked=False).bind(
            stream_id=1, tokens=jt2, cache=jc2)]
    tprogs = [
        tjit.build_dense_decode_template(tm1, tp1, 2, stacked=False).bind(
            stream_id=0, tokens=tt1, cache=tc1),
        tjit.build_dense_decode_template(tm2, tp2, 2, stacked=False).bind(
            stream_id=1, tokens=tt2, cache=tc2)]
    jx, tx = _jits()
    js, ts = jx.run(jprogs), tx.run(tprogs)
    assert ts.mean_group > 1.0 and ts.shared_dispatches == 0
    _same_stats(ts, js)
    for tprog, jprog in zip(tprogs, jprogs):
        _close(tprog.env["logits"], jprog.env["logits"])


def test_tied_unembed_and_layer_views_are_stable():
    """Every template of one params tree hands the executor the same
    weight objects, so the packed-weight guard never reads a template
    switch as a hot-swap."""
    _, _, _, _, tm, tp, tc, tt = _setup("gemma3-1b")
    a = tjit.build_dense_decode_template(tm, tp, 2, stacked=False)
    b = tjit.build_dense_prefill_template(tm, tp, 16, stacked=False)
    wa = [st.weight_fn() for st in a.stages if isinstance(st, tjit.GemmStage)]
    wb = [st.weight_fn() for st in b.stages if isinstance(st, tjit.GemmStage)]
    assert len(wa) == len(wb) and all(x is y for x, y in zip(wa, wb))
    jx = tjit.VLIWJit(max_group=8)
    for _ in range(2):
        jx.run([a.bind(stream_id=0, tokens=tt, cache=tc)])
    d = jx.executor.stats
    assert d.weight_invalidations == 0 and d.weight_hits == d.weight_misses


def test_vliwjit_defaults_to_the_h100_model():
    from repro_torch.core.costmodel import H100
    assert tjit.VLIWJit().cost.device is H100
    assert H100.num_units == 132 and H100.hbm_bw == 3.35e12
