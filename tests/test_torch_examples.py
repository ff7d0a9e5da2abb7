"""The port's four examples (``examples/torch_*.py``) on the CPU, each
run in-process through its ``main`` and held against the JAX package on
the same inputs: the weights carried across with
``models/convert.params_from_numpy`` from the JAX package's examples' own
seeds (``jax.random.PRNGKey(1)``, ``(2)``, ``(3)``; the training loop's
``PRNGKey(0)``), its prompts drawn as the JAX package draws them.

  * quickstart: the zoo's cluster count exactly; the first decode tokens
    exactly; the modelled speedup at ``TPUV5E`` within 1e-9 relative; the
    JIT's logits against the monolithic decode.
  * multi_tenant_serving: the ``vliw`` tokens and modelled ms against the
    JAX engine on the same trace (``TPUV5E``), tokens identical across
    modes.
  * autotune_blocks: the tuned blocks and speedups exactly; the
    superkernel's outputs against the JAX package's ``execute_superkernel``
    (fp32, 2e-4).
  * train_tiny: the first 3 losses within 2e-4 of the JAX package's
    ``train``; the loss falls; the checkpoint lands where ``--ckpt`` says.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JREGISTRY
from repro.configs import smoke_config as jax_smoke_config
from repro.core import Autotuner as JAutotuner
from repro.core import CostModel as JCostModel
from repro.core import TPUV5E as JTPUV5E
from repro.core import V100 as JV100
from repro.core import cluster_greedy as jcluster
from repro.core import zoo_population as jzoo
from repro.core.jit import VLIWJit as JaxJit
from repro.core.jit import build_dense_decode_program as jbuild
from repro.kernels.ops import execute_superkernel as jexecute
from repro.models import Model as JaxModel
from repro.serving import ServingEngine as JaxEngine, Tenant as JaxTenant
from repro.serving import make_trace as jmake_trace
from repro.training import DataConfig as JDataConfig
from repro.training import OptimizerConfig as JOptimizerConfig
from repro.training import SyntheticLM as JSyntheticLM
from repro.training import train as jtrain
from repro_torch.core import TPUV5E
from repro_torch.models.convert import params_from_numpy

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", EXAMPLES / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_params(arch, seed, num_layers=None):
    """(JAX model, its params, the port's copy of the params) on the CPU."""
    cfg = jax_smoke_config(arch)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    jm = JaxModel(cfg, param_dtype=jnp.float32)
    jp = jm.init(jax.random.PRNGKey(seed))
    return jm, jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                     device="cpu")


def _jax_prompt(cfg, req, rng=jax.random.PRNGKey(0)):
    """The JAX engine's prompt draw for ``req`` (run seed 0)."""
    return np.array(jax.random.randint(jax.random.fold_in(rng, req.req_id),
                                       (1, req.prompt_len), 0,
                                       cfg.vocab_size))


def test_quickstart_matches_the_reference(capsys):
    ex = _example("quickstart")
    rng = jax.random.PRNGKey(0)
    ref, params, prompts, first = [], {}, {}, {}
    for arch, seed in ex.TENANTS:
        jm, jp, tp = _jax_params(arch, seed)
        prompt = jax.random.randint(rng, (2, 12), 0, jm.cfg.vocab_size)
        logits, cache = jm.prefill(jp, {"tokens": prompt}, cache_len=32)
        tok = jnp.argmax(logits[:, -1, :jm.cfg.vocab_size], -1)[:, None]
        ref.append((jm, jp, tok.astype(jnp.int32), cache))
        params[arch] = tp
        prompts[arch] = torch.from_numpy(np.array(prompt)).long()
        first[arch] = tok[:, 0].tolist()
    jstats = JaxJit(JCostModel(JTPUV5E), max_group=8).run(
        [jbuild(m, p, t, c, stream_id=i)
         for i, (m, p, t, c) in enumerate(ref)])
    shapes = [s for _, _, s in jzoo(list(JREGISTRY.values()))]

    out = ex.main(["--device", "cpu"], cost_device=TPUV5E, params=params,
                  prompts=prompts)
    assert (out["zoo_problems"], out["clusters"]) == (
        len(shapes), len(jcluster(shapes))) == (70, 32)
    assert out["first_tokens"] == first
    assert (out["ops_executed"], out["superkernels"]) == (
        jstats.ops_executed, jstats.superkernels)
    assert out["modeled_speedup"] == pytest.approx(jstats.modeled_speedup,
                                                   rel=1e-9)
    assert max(out["max_err"].values()) < 1e-4
    text = capsys.readouterr().out
    assert "70 GEMM problems -> 32 clusters" in text
    assert f"modelled: {TPUV5E.name} cost model" in text
    assert "interpret" not in text and "Pallas" not in text


def test_multi_tenant_serving_matches_the_reference(capsys):
    ex = _example("multi_tenant_serving")
    jax_tenants, params = [], {}
    for name, arch, seed in ex.TENANTS:
        jm, jp, tp = _jax_params(arch, seed)
        jax_tenants.append(JaxTenant(name, jm, jp, cache_len=32,
                                     max_batch=4))
        params[arch] = tp
    trace = jmake_trace([name for name, _, _ in ex.TENANTS], rate_hz=2e4,
                        n_per_tenant=4, prompt_len=8, max_new_tokens=6,
                        slo_s=0.005, bursty=True)
    jrep = JaxEngine(jax_tenants, mode="vliw").run(trace)

    out = ex.main(["--device", "cpu"], cost_device=TPUV5E, params=params,
                  prompt_fn=lambda t, r: torch.from_numpy(
                      _jax_prompt(t.cfg, r)))
    vliw = out["modes"]["vliw"]
    assert vliw["tokens"] == {r.req_id: list(r.tokens_out)
                              for r in jrep.requests}
    assert vliw["modeled_ms"] == pytest.approx(jrep.modeled_time_s * 1e3,
                                               rel=1e-9)
    assert out["tokens_identical"]
    assert all(out["modes"][m]["tokens"] == vliw["tokens"]
               for m in ("time", "batched"))
    assert out["two_wave"]["wait"]["waits"] >= 1
    assert out["two_wave"]["never-wait"]["waits"] == 0
    assert "greedy tokens identical across regimes: True" in \
        capsys.readouterr().out


def test_autotune_blocks_matches_the_reference(capsys):
    ex = _example("autotune_blocks")
    shape_args = dict(m=784, n=512, k=1152, dtype_bytes=4)
    from repro.core import GemmShape as JGemmShape
    at = JAutotuner(JCostModel(JV100))
    rng = jax.random.PRNGKey(0)
    jprobs = []
    for i in range(2):
        ka, kb = jax.random.split(jax.random.fold_in(rng, i))
        jprobs.append((jax.random.normal(ka, (196, 288), jnp.float32),
                       jax.random.normal(kb, (288, 128), jnp.float32)))
    probs = [(torch.from_numpy(np.array(a)), torch.from_numpy(np.array(b)))
             for a, b in jprobs]

    out = ex.main(["--device", "cpu"], problems=probs)
    for K in (2, 4):
        r = at.tune(JGemmShape(**shape_args), co_tenants=K)
        got = out["tuned"][K]
        assert dataclasses.astuple(got["greedy"]) == \
            dataclasses.astuple(r.greedy)
        assert dataclasses.astuple(got["collaborative"]) == \
            dataclasses.astuple(r.collaborative)
        assert got["multiplexed_speedup"] == r.multiplexed_speedup
    b = at.tune(JGemmShape(**shape_args), co_tenants=2).collaborative
    assert out["bm"] == min(b.bm, 64)
    want = jexecute(jprobs, bm=min(b.bm, 64), bn=128, bk=min(b.bk, 96))
    for o, w in zip(out["outputs"], want):
        np.testing.assert_allclose(o.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4)
    assert out["max_err"] < 1e-3
    text = capsys.readouterr().out
    assert "stay modelled" in text and "interpret" not in text


def test_train_tiny_matches_the_reference(tmp_path, capsys):
    ex = _example("train_tiny")
    steps = 6
    jm, jp, tp = _jax_params("gemma3-1b", 0, num_layers=2)
    # the reference's first 3 steps under the 6-step schedule
    jres = jtrain(jm, JSyntheticLM(jm.cfg, JDataConfig(batch_size=8,
                                                       seq_len=128, seed=0)),
                  steps=3, opt_cfg=JOptimizerConfig(
                      lr=1e-3, warmup_steps=20, total_steps=steps),
                  rng=jax.random.PRNGKey(0), log_every=0)
    ckpt = tmp_path / "tiny.npz"
    out = ex.main(["--steps", str(steps), "--device", "cpu", "--ckpt",
                   str(ckpt)], params=tp)
    np.testing.assert_allclose(out["losses"][:3], jres["losses"],
                               rtol=2e-4, atol=2e-4)
    assert out["last"] < out["first"]
    assert out["ckpt_step"] == steps and ckpt.exists()
    assert f"checkpoint at step {steps}" in capsys.readouterr().out
    # the default checkpoint stays out of the tracked tree
    assert ex.DEFAULT_CKPT.parent.name == "build"
