"""The remaining model families in the port, on the CPU, against the JAX
package: vlm (internvl2-2b), hybrid (hymba-1.5b), audio (whisper-tiny)
and the int8 KV cache (gemma3-1b with ``kv_quant=True``).

Smoke configs, fp32, weights made by the JAX package and carried across
with ``params_from_numpy``; inputs from numpy with a seed; prompts through
``prompt_fn``.

  * kvquant: ``quantize`` bitwise (int8 codes and stored scales);
    ``dequantize`` and the int8 decode attention within 2e-4. A K/V value
    can sit within float noise of a rounding boundary, where the two
    frameworks' projections round it to neighbouring codes; the int8 model
    tests therefore hand both sides the same quantized cache at every
    step and keep 2e-4.
  * ``Model``: the init tree has the JAX package's keys, shapes and
    dtypes; prefill and three decode steps give logits within 2e-4.
  * The JIT: vlm decode compiles to the dense template (stacked bitwise
    equal to per-layer, both within 2e-4 of ``Model.decode_step``).
  * Serving: a mixed fleet (dense + vlm + hybrid + audio + int8-KV) gives
    the JAX engine's tokens in all three modes; vlm decode steps are
    KernelPrograms and the other three tenants take the monolithic step,
    as many times as in the JAX engine; a certified run on 2 modelled
    devices has 0 violations and balanced conservation.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core.costmodel import CostModel as JaxCostModel, TPUV5E as JTPU
from repro.models import Model as JaxModel
from repro.models import attention as jattn
from repro.models import kvquant as jkv
from repro.serving import ServingEngine as JaxEngine, Tenant as JaxTenant
from repro_torch.analysis import check_conservation
from repro_torch.configs import smoke_config
from repro_torch.core import jit as tjit
from repro_torch.core.costmodel import CostModel, TPUV5E
from repro_torch.models import Model
from repro_torch.models import attention as tattn
from repro_torch.models import kvquant as tkv
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import ServingEngine, Tenant, make_trace

TOL = dict(rtol=2e-4, atol=2e-4)
# family -> (arch, kv_quant)
FAMILIES = {"vlm": ("internvl2-2b", False), "hybrid": ("hymba-1.5b", False),
            "audio": ("whisper-tiny", False), "int8": ("gemma3-1b", True)}


def _make(family, seed=3):
    arch, kvq = FAMILIES[family]
    jm = JaxModel(jax_smoke_config(arch), param_dtype=jnp.float32,
                  kv_quant=kvq)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = Model(smoke_config(arch), param_dtype=torch.float32, device="cpu",
               kv_quant=kvq)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def models():
    return {f: _make(f) for f in FAMILIES}


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + k + "/"))
        else:
            out[pre + k] = v
    return out


def _np(x):
    return np.asarray(x).astype(np.float32) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


# ---------------------------------------------------------------------------
# kvquant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
def test_quantize_bitwise_equal_to_reference(scale_dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 4, 33, 32)) * 3.0).astype(np.float32)
    x[0, 0, 0] = 0.0                      # an all-zero row: the 1e-8 floor
    jq, js = jkv.quantize(jnp.asarray(x), scale_dtype=getattr(jnp,
                                                              scale_dtype))
    tq, ts = tkv.quantize(torch.from_numpy(x),
                          scale_dtype=getattr(torch, scale_dtype))
    assert tq.dtype == torch.int8 and tuple(ts.shape) == (2, 4, 33, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_np(ts), _np(js))
    np.testing.assert_allclose(
        tkv.dequantize(tq, ts, dtype=torch.float32).numpy(),
        np.asarray(jkv.dequantize(jq, js, dtype=jnp.float32)), **TOL)


@pytest.mark.parametrize("is_global", [True, False])
def test_int8_decode_attention_matches_reference(is_global):
    """One int8 decode step on the same params, input and quantized cache:
    output within 2e-4, the new scales within 2e-4, the written codes
    within one step (a rounding boundary) and every other code equal."""
    rng = np.random.default_rng(1)
    B, Hkv, H, hd, S, d, W = 3, 2, 4, 32, 24, 64, 8
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("wq", (d, H * hd)), ("wk", (d, Hkv * hd)),
                      ("wv", (d, Hkv * hd)), ("wo", (H * hd, d)))}
    x = rng.standard_normal((B, 1, d)).astype(np.float32)
    kq, ks = jkv.quantize(jnp.asarray(
        rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)),
        scale_dtype=jnp.float32)
    vq, vs = jkv.quantize(jnp.asarray(
        rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)),
        scale_dtype=jnp.float32)
    pos = np.array([3, 17, S + 2], np.int32)   # the last row writes nothing
    kw = dict(num_heads=H, num_kv_heads=Hkv, head_dim=hd, rope_theta=1e4,
              is_global=is_global, window=W)
    want = jattn.attention_decode(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), kq, vq,
        jnp.asarray(pos), k_scale=ks, v_scale=vs, **kw)
    got = tattn.attention_decode(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        *(torch.from_numpy(np.array(a)) for a in (kq, vq)),
        torch.from_numpy(pos),
        k_scale=torch.from_numpy(np.array(ks)),
        v_scale=torch.from_numpy(np.array(vs)), **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    for g, w in zip(got[1:3], want[1:3]):
        diff = np.abs(g.numpy().astype(np.int32)
                      - np.asarray(w).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).sum() <= 2
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_int8_cache_is_half_size():
    cfg = smoke_config("yi-9b")
    c = Model(cfg, param_dtype=torch.bfloat16, device="cpu",
              kv_quant=True).init_cache(2, 64)
    ref = Model(cfg, param_dtype=torch.bfloat16,
                device="cpu").init_cache(2, 64)
    layers = c["layers"]
    kv = layers["k"].nbytes + layers["v"].nbytes
    scales = layers["k_scale"].nbytes + layers["v_scale"].nbytes
    bf16 = ref["layers"]["k"].nbytes + ref["layers"]["v"].nbytes
    assert kv == bf16 // 2 and kv + scales < 0.6 * bf16
    assert scales == kv * 2 // cfg.resolved_head_dim


def test_kv_quant_skipped_for_ssm_and_audio():
    for arch in ("mamba2-2.7b", "whisper-tiny"):
        m = Model(smoke_config(arch), device="cpu", kv_quant=True)
        assert not m.kv_quant
        assert not JaxModel(jax_smoke_config(arch), kv_quant=True).kv_quant
    assert Model(smoke_config("hymba-1.5b"), device="cpu",
                 kv_quant=True).kv_quant


# ---------------------------------------------------------------------------
# Model against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", list(FAMILIES))
def test_init_tree_equals_reference(models, family):
    jm, jp, tm, _ = models[family]
    own = tm.init(torch.Generator().manual_seed(0))
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in _flat(jp).items()}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in _flat(own).items()}
    assert got == want
    # the decode cache too: keys, shapes, dtypes
    jc = jm.init_cache(2, 40)["layers"]
    tc = tm.init_cache(2, 40)["layers"]
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jc.items()} == \
        {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
         for k, v in tc.items()}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_params_carried_bitwise(models, family):
    _, jp, _, tp = models[family]
    want, got = _flat(jp), _flat(tp)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]), err_msg=k)


def _prompt_batch(cfg, rng, B, S):
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens":
                                             torch.from_numpy(toks).long()}
    extra = []
    if cfg.arch_type == "vlm":
        extra.append(("patch_embeds", cfg.num_patch_tokens))
    if cfg.is_encdec:
        extra.append(("frames", cfg.encoder_seq_len))
    for key, n in extra:
        a = rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)
        jb[key], tb[key] = jnp.asarray(a), torch.from_numpy(a)
    return jb, tb


@pytest.mark.parametrize("family", list(FAMILIES))
def test_prefill_and_decode_match_reference(models, family):
    jm, jp, tm, tp = models[family]
    cfg = tm.cfg
    rng = np.random.default_rng(2)
    B, S, CL = 2, 12, 40
    jb, tb = _prompt_batch(cfg, rng, B, S)
    jl, jc = jm.prefill(jp, jb, CL)
    tl, tc = tm.prefill(tp, tb, CL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert set(tc["layers"]) == set(jc["layers"])
    int8 = tm.kv_quant
    for k in tc["layers"]:
        assert str(tc["layers"][k].dtype).replace("torch.", "") == \
            str(jc["layers"][k].dtype), k
        if not (int8 and k in ("k", "v")):
            np.testing.assert_allclose(_np(tc["layers"][k]),
                                       _np(jc["layers"][k]), **TOL,
                                       err_msg=k)
    for _ in range(3):
        if int8:
            # the same quantized cache on both sides (module docstring)
            tc = {"pos": torch.from_numpy(np.array(jc["pos"])),
                  "layers": params_from_numpy(jc["layers"], "cpu")}
        tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(tok), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok).long(), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        assert tc["layers"].keys() == jc["layers"].keys()
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


# ---------------------------------------------------------------------------
# the JIT: vlm decode is the dense template
# ---------------------------------------------------------------------------

def _run_template(template, tokens, cache):
    prog = template.bind(stream_id=0, tokens=tokens, cache=cache)
    tjit.VLIWJit(CostModel(TPUV5E)).run([prog])
    return prog.env["logits"], prog.env["cache"]


def test_vlm_decode_template_matches_decode_step(models):
    _, _, tm, tp = models["vlm"]
    cfg = tm.cfg
    rng = np.random.default_rng(4)
    _, tb = _prompt_batch(cfg, rng, 2, 6)
    _, cache = tm.prefill(tp, tb, 32)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1))).long()
    want, wcache = tm.decode_step(tp, tok, cache)
    outs = {}
    for stacked in (False, True):
        outs[stacked] = _run_template(
            tjit.build_dense_decode_template(tm, tp, 2, stacked=stacked),
            tok, cache)
        np.testing.assert_allclose(outs[stacked][0].numpy(),
                                   want[:, 0].numpy(), **TOL)
        for k in ("k", "v"):
            np.testing.assert_allclose(outs[stacked][1]["layers"][k].numpy(),
                                       wcache["layers"][k].numpy(), **TOL)
    assert torch.equal(outs[True][0], outs[False][0])
    for k in ("k", "v"):
        assert torch.equal(outs[True][1]["layers"][k],
                           outs[False][1]["layers"][k])


# ---------------------------------------------------------------------------
# serving: the mixed fleet against the JAX engine
# ---------------------------------------------------------------------------

FLEET = (("t0:dense", "dense"), ("t1:vlm", "vlm"), ("t2:hybrid", "hybrid"),
         ("t3:audio", "audio"), ("t4:int8", "int8"))


@pytest.fixture(scope="module")
def fleet_models(models):
    jm = JaxModel(jax_smoke_config("yi-9b"), param_dtype=jnp.float32)
    jp = jm.init(jax.random.PRNGKey(9))
    tm = Model(smoke_config("yi-9b"), param_dtype=torch.float32,
               device="cpu")
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return {"dense": (jm, jp, tm, tp), **models}


def _jax_prompt(cfg, req, rng=jax.random.PRNGKey(0)):
    return np.array(jax.random.randint(jax.random.fold_in(rng, req.req_id),
                                       (1, req.prompt_len), 0,
                                       cfg.vocab_size))


def _trace():
    return make_trace([n for n, _ in FLEET], rate_hz=1e4, n_per_tenant=2,
                      prompt_len=6, max_new_tokens=3, slo_s=1.0)


def _count_steps(model, counts, name):
    """Wrap the model's ``decode_step`` (on this instance) to count the
    monolithic steps the engine takes for tenant ``name``."""
    inner = model.decode_step

    def step(*a, **kw):
        counts[name] = counts.get(name, 0) + 1
        return inner(*a, **kw)

    model.decode_step = step


def _engines(fleet_models, mode, **kw):
    """(JAX engine, port engine, JAX step counts, port step counts) on
    fresh model objects (so the step counters are per engine)."""
    jt, tt, jn, tn = [], [], {}, {}
    for name, fam in FLEET:
        jm, jp, tm, tp = fleet_models[fam]
        jm2 = JaxModel(jm.cfg, param_dtype=jnp.float32, kv_quant=jm.kv_quant)
        tm2 = Model(tm.cfg, param_dtype=torch.float32, device="cpu",
                    kv_quant=tm.kv_quant)
        _count_steps(jm2, jn, name)
        _count_steps(tm2, tn, name)
        jt.append(JaxTenant(name, jm2, jp, cache_len=32, max_batch=2))
        tt.append(Tenant(name, tm2, tp, cache_len=32, max_batch=2))
    jeng = JaxEngine(jt, mode=mode, cost=JaxCostModel(JTPU), **kw)
    teng = ServingEngine(
        tt, mode=mode, cost=CostModel(TPUV5E), device="cpu",
        prompt_fn=lambda t, r: torch.from_numpy(_jax_prompt(t.cfg, r)), **kw)
    return jeng, teng, jn, tn


def _tokens(rep):
    return {r.req_id: tuple(r.tokens_out or ()) for r in rep.requests}


@pytest.fixture(scope="module")
def fleet_runs(fleet_models):
    out = {}
    for mode in ("time", "batched", "vliw"):
        jeng, teng, jn, tn = _engines(fleet_models, mode)
        out[mode] = (jeng.run(_trace()), teng.run(_trace()), jn, tn, teng)
    return out


@pytest.mark.parametrize("mode", ["time", "batched", "vliw"])
def test_mixed_fleet_tokens_identical_to_reference(fleet_runs, mode):
    jrep, trep = fleet_runs[mode][:2]
    assert trep.unfinished == 0
    assert all(len(t) == 3 for t in _tokens(trep).values())
    assert _tokens(trep) == _tokens(jrep)
    assert _tokens(trep) == _tokens(fleet_runs["vliw"][1])


def test_vlm_programs_and_monolithic_steps_equal_reference(fleet_runs):
    jrep, trep, jn, tn, teng = fleet_runs["vliw"]
    # only the monolithic tenants call Model.decode_step in vliw mode
    assert set(tn) == {"t2:hybrid", "t3:audio", "t4:int8"}
    assert tn == jn
    # the vlm tenant's decode steps are dense-template KernelPrograms
    vlm = teng.tenants["t1:vlm"].cfg.name
    assert any(k[0] == "dense-decode" and k[1] == vlm
               for k in teng.jit.plan_cache.keys())
    j, t = jrep.jit, trep.jit
    assert t.superkernels == j.superkernels > 0
    assert t.ops_executed == j.ops_executed
    assert t.nondense_programs == j.nondense_programs == 0
    assert t.modeled_time_s == pytest.approx(j.modeled_time_s)
    assert trep.modeled_time_s == pytest.approx(jrep.modeled_time_s)


def test_certified_two_device_fleet(fleet_models):
    jeng, teng, _, _ = _engines(fleet_models, "vliw", certify=True,
                                num_devices=2)
    jrep, trep = jeng.run(_trace()), teng.run(_trace())
    assert _tokens(trep) == _tokens(jrep)
    assert trep.unfinished == 0
    assert trep.jit.hazard_checks == jrep.jit.hazard_checks > 0
    assert trep.jit.hazard_violations == 0
    assert check_conservation(teng.last_trace,
                              raise_on_violation=False) == []
    # the monolithic tenants' retirements are on the trace too
    retired = {rid for rid, _ in teng.last_trace.req_retires}
    assert retired == {r.req_id for r in trep.requests}
    assert trep.device_time_s == pytest.approx(jrep.device_time_s)
