"""Training in the port, on the CPU, against the JAX package.

Smoke configs (the six families: dense gemma3-1b, MoE grok-1, SSM
mamba2, hybrid hymba, vlm internvl2, audio whisper), fp32, weights made by
the JAX package and carried across with ``params_from_numpy``; batches
from ``SyntheticLM`` with a seed (numpy, so the same in both packages).

Tolerances, each stated where it is used:
  * ``lr_at`` within 1e-7 relative; ``adamw_update`` (clipping active)
    within 1e-6 per leaf and the grad norm within 1e-6 (both packages add
    in fp32, the port in JAX's leaf order);
  * ``SyntheticLM`` batches and fp32 checkpoints: bitwise;
  * ``Model.loss`` within 2e-4 (the repo's fp32 GEMM tolerance); every
    gradient leaf within 1e-3 × the leaf's max-abs, plus 1e-6;
  * the chunked attention (S = 2048) and the train step: as above;
  * ``remat=True`` against ``remat=False`` in the port: bitwise.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.configs.base import InputShape as JaxInputShape
from repro.models import Model as JaxModel
from repro.models import attention as jattn
from repro.training import checkpoint as jckpt
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro.training.train_loop import make_train_step as jax_train_step
from repro_torch.configs import smoke_config
from repro_torch.configs.base import InputShape
from repro_torch.models import Model
from repro_torch.models import attention as tattn
from repro_torch.models.convert import params_from_numpy
from repro_torch.training import (DataConfig, OptimizerConfig, OptState,
                                  SyntheticLM, adamw_update, batch_to_device,
                                  checkpoint_step, global_norm,
                                  init_opt_state, lr_at, make_train_step,
                                  restore_checkpoint, save_checkpoint, train)
from repro_torch.tree import flatten_with_path, leaves, path_key

SRC = Path(__file__).resolve().parents[1] / "src"
FAMILIES = ["gemma3-1b", "grok-1-314b", "mamba2-2.7b", "hymba-1.5b",
            "internvl2-2b", "whisper-tiny"]
LOSS_TOL = 2e-4


def _jax_model(arch, seed=1, remat=False):
    jm = JaxModel(jax_smoke_config(arch), param_dtype=jnp.float32,
                  remat=remat)
    return jm, jm.init(jax.random.PRNGKey(seed))


def _port(arch, jp, remat=False):
    tm = Model(smoke_config(arch), param_dtype=torch.float32, device="cpu",
               remat=remat)
    return tm, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 "cpu")


def _batch(arch, batch_size=2, seq_len=24, seed=3):
    return next(iter(jdata.SyntheticLM(
        jax_smoke_config(arch),
        jdata.DataConfig(batch_size=batch_size, seq_len=seq_len, seed=seed))))


def _port_loss_and_grads(tm, tp, batch):
    flat = leaves(tp)
    for p in flat:
        p.requires_grad_(True)
    loss = tm.loss(tp, batch_to_device(batch, tm))
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    for p in flat:
        p.requires_grad_(False)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(flat, grads)]


def _assert_grads_close(jax_grads, port_grads, paths):
    """Every leaf within 1e-3 × its max-abs, plus 1e-6."""
    jflat = jax.tree_util.tree_leaves(jax_grads)
    assert len(jflat) == len(port_grads)
    for path, a, b in zip(paths, jflat, port_grads):
        a = np.asarray(a)
        tol = 1e-3 * float(np.abs(a).max()) + 1e-6
        err = float(np.abs(a - b.numpy()).max())
        assert err <= tol, (path, err, tol)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_lr_at_matches_reference():
    cfg = OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                          min_lr_ratio=0.1)
    jcfg = jopt.OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                                min_lr_ratio=0.1)
    for step in (0, 5, 10, 55, 100, 120):
        want = float(jopt.lr_at(jcfg, jnp.asarray(step)))
        got = float(lr_at(cfg, torch.tensor(step)))
        assert got == pytest.approx(want, rel=1e-7, abs=0.0), step


def _opt_tree(rng):
    # keys inserted out of order: the norm must add in sorted-key order
    return {"w": rng.standard_normal((8, 8)).astype(np.float32),
            "b": rng.standard_normal((8,)).astype(np.float32),
            "a": {"z": rng.standard_normal((4, 16)).astype(np.float32),
                  "c": rng.standard_normal((3,)).astype(np.float32)}}


def test_adamw_update_matches_reference_with_clipping():
    rng = np.random.default_rng(0)
    params = _opt_tree(rng)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=1.0)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.init_opt_state(jp)
    tp = params_from_numpy(params, "cpu")
    ts = init_opt_state(tp)
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: (50.0 * rng.standard_normal(x.shape)).astype(
                np.float32), params)
        jp, js, jm = jopt.adamw_update(jopt.OptimizerConfig(**cfg), jp,
                                       jax.tree_util.tree_map(jnp.asarray,
                                                              grads), js)
        tp, ts, tm = adamw_update(OptimizerConfig(**cfg), tp,
                                  params_from_numpy(grads, "cpu"), ts)
        assert float(jm["grad_norm"]) > 1.0        # clipping is active
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-7)
        assert int(ts.step) == int(js.step) == step + 1
        for tree_j, tree_t in ((jp, tp), (js.mu, ts.mu), (js.nu, ts.nu)):
            for (path, a), b in zip(
                    jax.tree_util.tree_flatten_with_path(tree_j)[0],
                    leaves(tree_t)):
                np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                           rtol=1e-6, atol=1e-6,
                                           err_msg=str(path))


@pytest.mark.parametrize("arch", FAMILIES)
def test_tree_order_is_jax_flatten_order(arch):
    """The port's leaves come in JAX's order (sorted dict keys), so the
    global norm adds in the reference's order and checkpoint keys match."""
    _, jp = _jax_model(arch)
    tm, tp = _port(arch, jp)
    jpaths = ["/".join(str(getattr(k, "key", k)) for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert jpaths == [path_key(p) for p, _ in flatten_with_path(tp)]
    grads = jax.tree_util.tree_map(lambda x: x * 3.0 + 1.0, jp)
    want = float(jopt.global_norm(grads))
    got = float(global_norm(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, grads), "cpu")))
    assert got == pytest.approx(want, rel=1e-6)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["yi-9b", "internvl2-2b", "whisper-tiny"])
def test_synthetic_lm_batches_bitwise_equal(arch):
    want = jdata.SyntheticLM(jax_smoke_config(arch),
                             jdata.DataConfig(batch_size=3, seq_len=40,
                                              seed=5))
    got = SyntheticLM(smoke_config(arch),
                      DataConfig(batch_size=3, seq_len=40, seed=5))
    for _ in range(3):
        a, b = next(want), next(got)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _ckpt_trees(arch="hymba-1.5b"):
    _, jp = _jax_model(arch)
    rng = np.random.default_rng(4)
    jopt_state = jopt.init_opt_state(jp)
    jopt_state = jopt.OptState(
        step=jnp.asarray(7, jnp.int32),
        mu=jax.tree_util.tree_map(lambda x: jnp.asarray(
            rng.standard_normal(x.shape).astype(np.float32)), jopt_state.mu),
        nu=jax.tree_util.tree_map(lambda x: jnp.asarray(
            rng.random(x.shape).astype(np.float32)), jopt_state.nu))
    jtree = {"params": jp, "opt": jopt_state}
    ttree = {"params": params_from_numpy(
                 jax.tree_util.tree_map(np.asarray, jp), "cpu"),
             "opt": OptState(
                 step=torch.tensor(7, dtype=torch.int32),
                 mu=params_from_numpy(jax.tree_util.tree_map(
                     np.asarray, jopt_state.mu), "cpu"),
                 nu=params_from_numpy(jax.tree_util.tree_map(
                     np.asarray, jopt_state.nu), "cpu"))}
    return jtree, ttree


def _assert_trees_bitwise(jtree, ttree):
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tflat = list(flatten_with_path(ttree))
    assert len(jflat) == len(tflat)
    for (jpath, a), (tpath, b) in zip(jflat, tflat):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype, (tpath, a.dtype, b.dtype)
        np.testing.assert_array_equal(b.numpy(), a, err_msg=str(tpath))


def test_checkpoint_reference_to_port_bitwise(tmp_path):
    jtree, ttree = _ckpt_trees()
    path = os.path.join(tmp_path, "ref.npz")
    jckpt.save_checkpoint(path, jtree, step=7)
    got = restore_checkpoint(path, ttree)
    assert checkpoint_step(path) == 7
    assert isinstance(got["opt"], OptState)
    _assert_trees_bitwise(jtree, got)


def test_checkpoint_port_to_reference_bitwise(tmp_path):
    jtree, ttree = _ckpt_trees()
    path = os.path.join(tmp_path, "port.npz")
    save_checkpoint(path, ttree, step=9)
    ref = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jtree)
    got = jckpt.restore_checkpoint(path, ref)
    assert jckpt.checkpoint_step(path) == 9
    _assert_trees_bitwise(got, ttree)


def test_checkpoint_bf16_roundtrips_and_crosses(tmp_path):
    """bf16 round-trips in the port; a reference-written bf16 array
    (numpy reads it as two-byte voids) restores in the port bit for bit,
    and a port-written bf16 leaf (widened to fp32) restores in the
    reference bit for bit."""
    rng = np.random.default_rng(6)
    vals = rng.standard_normal((5, 7)).astype(np.float32)
    t = {"w": torch.from_numpy(vals).to(torch.bfloat16),
         "s": torch.tensor(3, dtype=torch.int32)}
    path = os.path.join(tmp_path, "bf.npz")
    save_checkpoint(path, t)
    back = restore_checkpoint(path, t)
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"].view(torch.int16), t["w"].view(torch.int16))
    j = {"w": jnp.asarray(vals, jnp.bfloat16),
         "s": jnp.asarray(3, jnp.int32)}
    jref = jckpt.restore_checkpoint(path, j)
    np.testing.assert_array_equal(np.asarray(jref["w"]).view(np.uint16),
                                  np.asarray(j["w"]).view(np.uint16))
    jpath = os.path.join(tmp_path, "jbf.npz")
    jckpt.save_checkpoint(jpath, j)
    from_ref = restore_checkpoint(jpath, t)
    np.testing.assert_array_equal(
        from_ref["w"].view(torch.int16).numpy().view(np.uint16),
        np.asarray(j["w"]).view(np.uint16))


# ---------------------------------------------------------------------------
# the model's training entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_reference(arch):
    """S = 24: not a multiple of the smoke SSM chunk (16), so mamba2 and
    hymba run the padded-chunk path (the in-place ``dt`` freeze)."""
    jm, jp = _jax_model(arch)
    tm, tp = _port(arch, jp)
    batch = _batch(arch)
    jl, jg = jax.value_and_grad(jm.loss)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tg = _port_loss_and_grads(tm, tp, batch)
    assert abs(float(tl) - float(jl)) <= LOSS_TOL, (float(tl), float(jl))
    _assert_grads_close(jg, tg, [path_key(p) for p, _ in
                                 flatten_with_path(tp)])


def test_forward_logits_match_reference():
    jm, jp = _jax_model("gemma3-1b")
    tm, tp = _port("gemma3-1b", jp)
    batch = _batch("gemma3-1b")
    jlog, jaux = jm.forward(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        tlog, taux = tm.forward(tp, batch_to_device(batch, tm))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=2e-4,
                               atol=2e-4)
    assert float(taux) == float(jaux) == 0.0


CHUNK_CASES = {  # name -> (is_global, window, causal)
    "full_branch": (True, 1024, True),
    "banded_branch": (False, 1024, True),
    "masked_fallback": (False, 1536, True),     # Wlen = S: no band slice
    "bidirectional": (True, 0, False),
}


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_chunked_attention_matches_reference(case):
    """S = 2048, B = 1, one kv head, G = 2, hd = 16: output within 2e-4,
    the q / k / v grads within 1e-3 × max-abs + 1e-6."""
    is_global, window, causal = CHUNK_CASES[case]
    rng = np.random.default_rng(11)
    B, S, Hkv, G, hd = 1, 2048, 1, 2, 16
    q = rng.standard_normal((B, S, Hkv, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    w = rng.standard_normal((B, S, Hkv * G * hd)).astype(np.float32)
    kw = dict(is_global=is_global, window=window, causal=causal,
              head_dim=hd)

    def jf(q, k, v):
        return jnp.sum(jattn._attention_chunked(q, k, v, **kw) * w)

    jout = jattn._attention_chunked(q, k, v, **kw)
    jg = jax.grad(jf, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    tout = tattn._attention_chunked(tq, tk, tv, **kw)
    tg = torch.autograd.grad((tout * torch.from_numpy(w)).sum(),
                             (tq, tk, tv))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=2e-4, atol=2e-4)
    _assert_grads_close(jg, list(tg), ["dq", "dk", "dv"])


def test_loss_at_2048_takes_both_chunked_branches():
    """Smoke gemma3-1b at S = 2048 (d_model 128, B = 1): layer 0 is local
    (window 32: the banded branch), layer 1 global (the full branch), and
    the CE runs four chunks of 512. Loss within 2e-4, grads as above."""
    jm, jp = _jax_model("gemma3-1b")
    tm, tp = _port("gemma3-1b", jp)
    assert smoke_config("gemma3-1b").global_layer_flags() == (False, True)
    batch = _batch("gemma3-1b", batch_size=1, seq_len=2048)
    jl, jg = jax.value_and_grad(jm.loss)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tg = _port_loss_and_grads(tm, tp, batch)
    assert abs(float(tl) - float(jl)) <= LOSS_TOL
    _assert_grads_close(jg, tg, [path_key(p) for p, _ in
                                 flatten_with_path(tp)])


@pytest.mark.parametrize("arch,seq_len", [("gemma3-1b", 2048),
                                          ("grok-1-314b", 24),
                                          ("mamba2-2.7b", 24),
                                          ("whisper-tiny", 24)])
def test_remat_is_bitwise_equal(arch, seq_len):
    _, jp = _jax_model(arch)
    batch = _batch(arch, batch_size=1, seq_len=seq_len)
    tm, tp = _port(arch, jp)
    rm, rp = _port(arch, jp, remat=True)
    l0, g0 = _port_loss_and_grads(tm, tp, batch)
    l1, g1 = _port_loss_and_grads(rm, rp, batch)
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_train_step_matches_reference_jitted_step():
    """One ``make_train_step`` of each package from the same params and
    batch: params, moments, loss and metrics within 2e-4."""
    arch = "gemma3-1b"
    jm, jp = _jax_model(arch)
    tm, tp = _port(arch, jp)
    batch = _batch(arch, batch_size=2, seq_len=32)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jax_train_step(jm, jopt.OptimizerConfig(**kw)))
    jp2, js2, jmet = jstep(jp, jopt.init_opt_state(jp),
                           {k: jnp.asarray(v) for k, v in batch.items()})
    tstep = make_train_step(tm, OptimizerConfig(**kw))
    tp2, ts2, tmet = tstep(tp, init_opt_state(tp), batch_to_device(batch,
                                                                   tm))
    for key in ("loss", "grad_norm", "lr"):
        assert float(tmet[key]) == pytest.approx(float(jmet[key]),
                                                 rel=2e-4, abs=2e-4), key
    for tree_j, tree_t in ((jp2, tp2), (js2.mu, ts2.mu), (js2.nu, ts2.nu)):
        for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(
                tree_j)[0], leaves(tree_t)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-4,
                                       atol=2e-4, err_msg=str(path))


def test_train_loss_decreases():
    """The reference's ``test_train_loss_decreases``, through the port's
    own ``train``."""
    cfg = smoke_config("gemma3-1b")
    m = Model(cfg, param_dtype=torch.float32, device="cpu")
    res = train(m, SyntheticLM(cfg, DataConfig(batch_size=4, seq_len=64)),
                steps=40, log_every=0,
                opt_cfg=OptimizerConfig(lr=1e-3, warmup_steps=5,
                                        total_steps=40))
    losses = res["losses"]
    assert all(np.isfinite(losses))
    assert sum(losses[-5:]) / 5 < sum(losses[:5]) / 5 - 0.05


def test_train_writes_a_checkpoint_that_restores(tmp_path):
    cfg = smoke_config("yi-9b")
    m = Model(cfg, param_dtype=torch.float32, device="cpu")
    path = os.path.join(tmp_path, "run.npz")
    res = train(m, SyntheticLM(cfg, DataConfig(batch_size=2, seq_len=16)),
                steps=2, log_every=0, checkpoint_path=path,
                checkpoint_every=2)
    assert checkpoint_step(path) == 2
    tree = {"params": res["params"], "opt": res["opt_state"]}
    back = restore_checkpoint(path, tree)
    for a, b in zip(leaves(tree), leaves(back)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["gemma3-1b", "internvl2-2b",
                                  "whisper-tiny", "mamba2-2.7b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_match_reference(arch, kind):
    shape = (64, 2)
    jm = JaxModel(jax_smoke_config(arch), param_dtype=jnp.float32)
    tm = Model(smoke_config(arch), param_dtype=torch.float32, device="cpu")
    want = jm.input_specs(JaxInputShape("s", *shape, kind))
    got = tm.input_specs(InputShape("s", *shape, kind))
    jflat = jax.tree_util.tree_flatten_with_path(want)[0]
    tflat = list(flatten_with_path(got))
    assert [path_key(p) for p, _ in tflat] == [
        "/".join(str(getattr(k, "key", k)) for k in p) for p, _ in jflat]
    for (_, a), (path, b) in zip(jflat, tflat):
        assert b.device.type == "meta"
        assert tuple(b.shape) == tuple(a.shape), path
        assert str(b.dtype).split(".")[-1] == np.dtype(a.dtype).name, path


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _launch(*args):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        cwd=SRC.parent, env=env, capture_output=True, text=True,
        timeout=240)


def test_launcher_smoke_on_the_cpu():
    out = _launch("--device", "cpu", "--steps", "3", "--batch-size", "2",
                  "--seq-len", "32")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "3 steps in" in out.stdout and "mesh=None" in out.stdout


def test_launcher_production_on_a_world1_gloo_mesh(tmp_path):
    ckpt = os.path.join(tmp_path, "prod.npz")
    out = _launch("--device", "cpu", "--production", "--smoke",
                  "--arch", "grok-1-314b", "--steps", "2",
                  "--batch-size", "2", "--seq-len", "32",
                  "--checkpoint", ckpt)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "mesh={'data': 1, 'model': 1}" in out.stdout
    assert "dtype=bfloat16" in out.stdout and "2 steps in" in out.stdout
    assert checkpoint_step(ckpt) == 2
