"""The port's SPMD layer past one rank, on the CPU: worlds of 2 and 4 gloo
processes against one process.

How a multi-rank case runs (no pytest process ever holds a process group
of more than one rank): the test starts each rank as a fresh interpreter
(``subprocess.Popen``, a session of its own, ``OMP_NUM_THREADS=1``,
``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` in its environment, a
``file://`` rendezvous in the test's directory, a process-group timeout of
60 s). A rank runs the training launcher or this file as a script (the
``__main__`` block below) and writes what it computed to the test's
directory as ``.npz``; the test compares that with one process. If the
ranks are not done within 120 s the test kills their sessions and fails
with their stderr.

  * the fault: ``gather_at_use``'s gradient on a world of 2 whose ranks
    hold different inputs is the sum of the ranks' gradients;
  * dense (gemma3-1b smoke, fp32): world 4 on (data 2, model 2), the
    FFN and the vocabulary tensor-parallel over "model", and on (pod 2,
    data 2, model 1): the first step's loss within 2e-4 and each gathered
    gradient leaf within 1e-3 × its max-abs + 1e-6 of the JAX package's
    one-device loss and gradients and of the port's plain one-process
    step, on the global batch; the ranks' ``global_norm`` of their DTensor
    gradients equal to the norm of the gathered ones; then, on the same
    ranks, a prefill of 30-token prompts into the 64-position cache
    ``cache_shardings`` places (sequence over "model": 32 positions a
    rank on (2, 2), the local layers' 32-token band straddling them) and
    4 greedy decode steps: tokens identical to one process and to the
    JAX package, the last step's logits within 2e-4; the launcher's
    losses over 3 steps at world 4 within 2e-4 of a world-1 run; every
    weight gathered a layer at a time where the layer runs (inside its
    remat body), the served ranks' too;
  * MoE (grok-1 smoke, fp32): world 4 on (2, 2), expert-parallel over
    "data" (each rank holds 2 of the 4 experts and trades the dispatched
    tokens by all-to-all) and each expert's d_ff tensor-parallel over
    "model", against the JAX package's one-device loss and gradients
    under ``moe_groups = 2``, same tolerances;
  * the checkpoint of a world-4 step restores at world 1 bitwise to the
    params the ranks gathered.

One process: a remat step whose backward runs on another thread (as the
autograd engine runs a CUDA backward) recomputes under the forward's
hints, and ``local_block`` / the launcher's mesh checks.
"""
import functools
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PG_TIMEOUT_S = 60
RUN_TIMEOUT_S = 120
LOSS_TOL = 2e-4
BATCH, SEQ = 4, 32
# the served prompt and cache: gemma3-1b smoke's 32-token window straddles
# the two "model" ranks' 32-position blocks from position 32 on
PROMPT, CACHE_LEN, DECODE_STEPS = 30, 64, 4


# ---------------------------------------------------------------------------
# the ranks' side: this file run as a script
# ---------------------------------------------------------------------------

def _rank_gather(out: Path):
    """World 2 on a 1-D data mesh: w [4, 3] sharded on its rows, rank r's
    input x_r [5, 4] from seed 10 + r, loss tanh(x_r @ w).sum()."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.distributed.sharding import full, gather_at_use
    rank = dist.get_rank()
    mesh = init_device_mesh("cpu", (dist.get_world_size(),),
                            mesh_dim_names=("data",))
    w = distribute_tensor(_gather_w(), mesh, [Shard(0)]).requires_grad_()
    x = _gather_x(rank)
    loss = torch.tanh(x @ gather_at_use({"w": w}, ("data",))["w"]).sum()
    (g,) = torch.autograd.grad(loss, [w])
    np.savez(out / f"rank{rank}.npz", grad=full(g).numpy())


def _gather_w():
    return torch.from_numpy(
        np.random.default_rng(1).standard_normal((4, 3)).astype(np.float32))


def _gather_x(rank):
    return torch.from_numpy(np.random.default_rng(10 + rank)
                            .standard_normal((5, 4)).astype(np.float32))


def _load_params(path: Path):
    """A flat ``.npz`` keyed by tree path (``_params_tree``)."""
    with np.load(path) as data:
        return _params_tree({k: data[k] for k in data.files})


def _params_tree(flat: dict):
    """Flat numpy arrays keyed by tree path as the nested tree, carried
    across by ``params_from_numpy``."""
    from repro_torch.models.convert import params_from_numpy
    tree = {}
    for key, v in flat.items():
        node = tree
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return params_from_numpy(tree, "cpu")


def _rank_step(out: Path, arch: str, mesh_text: str, params_npz: str):
    """One production step of ``arch``'s smoke config, fp32, remat, on a
    mesh of ``mesh_text`` ("data,model" or "pod,data,model") from the
    params in ``params_npz``, on the global batch: writes the loss, the
    gathered gradients of ``loss_and_grads`` and the params gathered after
    the step; saves the step's checkpoint."""
    import torch.distributed as dist

    from repro_torch.configs import smoke_config
    from repro_torch.distributed.hints import activation_sharding
    from repro_torch.distributed.sharding import full, gather_at_use
    from repro_torch.launch.mesh import (AXES, MULTI_POD_AXES, make_mesh,
                                         production_state)
    from repro_torch.models import Model
    from repro_torch.training import (OptimizerConfig, batch_to_device,
                                      loss_and_grads, make_train_step,
                                      save_checkpoint)
    from repro_torch.training.optimizer import global_norm
    from repro_torch.tree import flatten_with_path, path_key
    sizes = [int(n) for n in mesh_text.split(",")]
    names = MULTI_POD_AXES if len(sizes) == 3 else AXES
    mesh = make_mesh(dict(zip(names, sizes)), "cpu")
    cfg = smoke_config(arch)
    model = Model(cfg, param_dtype=torch.float32, device="cpu", remat=True)
    dparams, dopt, hints = production_state(
        model, _load_params(Path(params_npz)), mesh, BATCH)
    batch = batch_to_device(_batch(arch), model)
    served = _rank_decode(model, dparams, mesh, hints, batch) \
        if arch == "gemma3-1b" else {}
    with activation_sharding(hints):
        used = gather_at_use(dparams)
        held = {f"held/{k}": np.array(used["blocks"]["moe"][k].shape)
                for k in ("w_gate", "w_up", "w_down")} if cfg.has_moe else {}
        loss, dgrads = loss_and_grads(model, dparams, batch)
        norm = global_norm(dgrads)
        grads = {path_key(p): full(g).numpy()
                 for p, g in flatten_with_path(dgrads)}
        step = make_train_step(model, OptimizerConfig(
            lr=1e-3, warmup_steps=1, total_steps=4))
        dparams, dopt, _ = step(dparams, dopt, batch)
    stepped = {path_key(p): full(t).numpy()
               for p, t in flatten_with_path(dparams)}
    save_checkpoint(str(out / "ckpt.npz"), {"params": dparams, "opt": dopt},
                    step=1)
    np.savez(out / f"rank{dist.get_rank()}.npz", loss=loss.numpy(),
             grad_norm=norm.numpy(), **served, **held,
             **{f"grad/{k}": v for k, v in grads.items()},
             **{f"param/{k}": v for k, v in stepped.items()})


def _rank_decode(model, dparams, mesh, hints, batch):
    """The rank's block of ``_greedy``'s prompts prefilled into the cache
    ``cache_shardings`` places (sequence over "model"), then
    ``DECODE_STEPS`` greedy steps on it: the tokens, the last step's
    logits and the global rows of the block."""
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed.hints import activation_sharding
    from repro_torch.distributed.sharding import (batch_shardings,
                                                  local_block)
    prefill = batch_shardings(model, InputShape("p", PROMPT, BATCH,
                                                "prefill"), mesh)["tokens"]
    c_sh = batch_shardings(model, InputShape("d", CACHE_LEN, BATCH,
                                             "decode"), mesh)["cache"]
    rows = local_block(torch.arange(BATCH)[:, None], prefill)[:, 0]
    prompts = local_block(batch["tokens"][:, :PROMPT], prefill)
    with torch.no_grad(), activation_sharding(hints):
        tokens, logits, cache = _greedy(model, dparams, prompts,
                                        cache_shardings=c_sh)
    return {"decode_tokens": tokens.numpy(), "decode_logits": logits.numpy(),
            "decode_rows": rows.numpy(),
            "decode_block": np.int64(cache["layers"]["k"].to_local()
                                     .shape[3])}


def _greedy(model, params, prompts, **kw):
    """Prefill ``prompts`` into a cache of ``CACHE_LEN`` positions, then
    ``DECODE_STEPS`` greedy decode steps: (the prefill's token and the
    steps', [B, 1 + DECODE_STEPS]; the last step's logits [B, 1, V]; the
    cache)."""
    logits, cache = model.prefill(params, {"tokens": prompts}, CACHE_LEN,
                                  **kw)
    toks = [logits.argmax(-1)]
    for _ in range(DECODE_STEPS):
        logits, cache = model.decode_step(params, toks[-1], cache)
        toks.append(logits.argmax(-1))
    return torch.cat(toks, dim=1), logits, cache


def _batch(arch):
    """The global batch (numpy, as the JAX package's ``SyntheticLM`` draws
    it); the dense one with a loss mask that keeps a different share of
    each row's targets, so the ranks' target counts differ and the mean of
    their means is not the global mean."""
    from repro_torch.configs import smoke_config
    from repro_torch.training import DataConfig, SyntheticLM
    batch = next(iter(SyntheticLM(smoke_config(arch), DataConfig(
        batch_size=BATCH, seq_len=SEQ, seed=2))))
    if arch == "gemma3-1b":
        keep = np.array([0.9, 0.5, 0.2, 0.7])[:, None]
        batch["loss_mask"] = (np.random.default_rng(5).random((BATCH, SEQ))
                              < keep).astype(np.float32)
    return batch


def _rank_main(argv):
    """``test_torch_world.py CASE OUT [ARGS...]``, RANK and WORLD_SIZE in
    the environment; the rendezvous is ``OUT/pg``."""
    from repro_torch.launch.mesh import ensure_process_group
    case, out, *rest = argv
    out = Path(out)
    ensure_process_group("cpu", (out / "pg").as_uri(), PG_TIMEOUT_S)
    try:
        if case == "gather":
            _rank_gather(out)
        elif case == "step":
            _rank_step(out, *rest)
        else:
            raise ValueError(case)
    finally:
        torch.distributed.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# the test's side
# ---------------------------------------------------------------------------

def _start_ranks(out: Path, world: int, argv):
    """``argv`` as ``world`` fresh interpreters, each in a session of its
    own, its stdout and stderr in ``out``; ``_wait_ranks`` joins them."""
    out.mkdir(parents=True, exist_ok=True)
    procs, logs = [], []
    for r in range(world):
        env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
                   RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r))
        for k in ("MASTER_ADDR", "MASTER_PORT"):
            env.pop(k, None)
        so, se = out / f"rank{r}.out", out / f"rank{r}.err"
        logs.append((so, se))
        with open(so, "w") as fo, open(se, "w") as fe:
            procs.append(subprocess.Popen(
                [sys.executable, *argv], cwd=ROOT, env=env, stdout=fo,
                stderr=fe, stdin=subprocess.DEVNULL, start_new_session=True))
    return procs, logs, time.monotonic() + RUN_TIMEOUT_S


def _wait_ranks(started) -> list:
    """The ranks' stdouts once all exit 0. Past ``RUN_TIMEOUT_S`` from
    their start, their sessions are killed and the test fails."""
    procs, logs, deadline = started
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        for p in procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        for p in procs:
            p.wait()
        pytest.fail(f"ranks over {RUN_TIMEOUT_S} s:\n" + _stderr(logs))
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, f"ranks {bad} failed:\n" + _stderr(logs)
    return [so.read_text() for so, _ in logs]


def _run_ranks(out: Path, world: int, argv) -> list:
    return _wait_ranks(_start_ranks(out, world, argv))


def _stderr(logs) -> str:
    return "\n".join(f"--- rank {r}\n{se.read_text()[-3000:]}"
                     for r, (_, se) in enumerate(logs))


def _script(case, out, *args):
    return [str(Path(__file__).resolve()), case, str(out), *args]


def _assert_grads_close(want: dict, got: dict):
    """Every leaf within 1e-3 × its max-abs, plus 1e-6."""
    assert sorted(want) == sorted(got)
    for k, a in want.items():
        tol = 1e-3 * float(np.abs(a).max()) + 1e-6
        err = float(np.abs(a - got[k]).max())
        assert err <= tol, (k, err, tol)


def _ranks_npz(out, world):
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]


def _by_prefix(d, prefix):
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


def _plain_loss_and_grads(model, params, batch):
    from repro_torch.training import loss_and_grads
    from repro_torch.tree import flatten_with_path, path_key
    loss, grads = loss_and_grads(model, params, batch)
    return float(loss), {path_key(p): g.numpy()
                         for p, g in flatten_with_path(grads)}


def test_gather_at_use_sums_the_ranks_gradients(tmp_path):
    """The gathered weight's gradient on each rank is the sum over the
    ranks of their own gradients (the default ``grad_placements`` would
    leave each rank its own, unsummed)."""
    _run_ranks(tmp_path, 2, _script("gather", tmp_path))
    w = _gather_w().requires_grad_()
    want = sum(torch.autograd.grad(torch.tanh(_gather_x(r) @ w).sum(),
                                   [w])[0] for r in range(2)).numpy()
    for r, got in enumerate(_ranks_npz(tmp_path, 2)):
        np.testing.assert_allclose(got["grad"], want, rtol=1e-6, atol=1e-6,
                                   err_msg=f"rank {r}")


def _jax_flat(tree) -> dict:
    """A JAX tree as numpy arrays keyed by tree path (the port's
    ``path_key`` scheme)."""
    import jax
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _jax_model(arch):
    """The JAX package's ``arch`` smoke model, fp32, and its params from
    ``PRNGKey(1)``, flat (``_jax_flat``)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import smoke_config as jax_smoke_config
    from repro.models import Model as JaxModel
    jm = JaxModel(jax_smoke_config(arch), param_dtype=jnp.float32)
    jp = jm.init(jax.random.PRNGKey(1))
    return jm, jp, _jax_flat(jp)


def _start_step_ranks(out: Path, arch: str, mesh_text: str):
    """Four ranks of ``_rank_step`` from the JAX package's params."""
    np.savez(out / "params.npz", **_jax_model(arch)[2])
    return _start_ranks(out, 4, _script("step", out, arch, mesh_text,
                                        str(out / "params.npz")))


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(arch, moe_groups=0):
    """The JAX package's one-device loss and gradients on the global
    batch, under ``moe_groups`` when it is set."""
    import contextlib

    import jax
    import jax.numpy as jnp

    from repro.distributed.hints import activation_sharding as jax_hints
    jm, jp, _ = _jax_model(arch)
    batch = {k: jnp.asarray(v) for k, v in _batch(arch).items()}
    with (jax_hints({"moe_groups": moe_groups}) if moe_groups
          else contextlib.nullcontext()):
        loss, grads = jax.value_and_grad(jm.loss)(jp, batch)
    return float(loss), _jax_flat(grads)


@functools.lru_cache(maxsize=1)
def _dense_plain():
    """gemma3-1b smoke, fp32, from the JAX package's params: the port's
    model, params and plain one-process (loss, grads)."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import Model
    from repro_torch.training import batch_to_device
    model = Model(smoke_config("gemma3-1b"), param_dtype=torch.float32,
                  device="cpu")
    params = _params_tree(_jax_model("gemma3-1b")[2])
    return model, params, _plain_loss_and_grads(
        model, params, batch_to_device(_batch("gemma3-1b"), model))


@pytest.fixture(scope="module")
def dense_world(tmp_path_factory):
    """gemma3-1b smoke, world 4 on (data 2, model 2): the ranks' output."""
    out = tmp_path_factory.mktemp("dense_2x2")
    return out, _run_dense(out, "2,2")


def _run_dense(out: Path, mesh_text: str) -> list:
    """gemma3-1b smoke on four ranks, the one-process references computed
    while they run: the ranks' output."""
    ranks = _start_step_ranks(out, "gemma3-1b", mesh_text)
    try:
        _jax_loss_and_grads("gemma3-1b")
        _dense_plain()
        _jax_greedy()
        _plain_greedy()
    finally:
        _wait_ranks(ranks)
    return _ranks_npz(out, 4)


def _norm(grads: dict) -> float:
    return float(np.sqrt(sum(np.sum(np.square(g.astype(np.float64)))
                             for g in grads.values())))


def _assert_ranks_equal_plain(ranks, loss, grads):
    """Each rank's loss and gathered gradients against ``loss`` and
    ``grads``; its ``global_norm`` of the DTensor gradients (each "model"
    block counted once) against the norm of its gathered ones, and within
    1e-4 of the norm of ``grads``."""
    for r, got in enumerate(ranks):
        assert abs(float(got["loss"]) - loss) <= LOSS_TOL, (r, got["loss"],
                                                           loss)
        mine = _by_prefix(got, "grad/")
        _assert_grads_close(grads, mine)
        # every rank gathers the same bits
        for k, v in mine.items():
            np.testing.assert_array_equal(v, ranks[0][f"grad/{k}"])
        np.testing.assert_allclose(float(got["grad_norm"]), _norm(mine),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(got["grad_norm"]), _norm(grads),
                                   rtol=1e-4)


@functools.lru_cache(maxsize=None)
def _jax_greedy():
    """The JAX package's gemma3-1b prefill of ``_greedy``'s prompts and
    its decode steps, one device: (tokens, the last step's logits)."""
    import jax.numpy as jnp
    jm, jp, _ = _jax_model("gemma3-1b")
    prompts = jnp.asarray(_batch("gemma3-1b")["tokens"][:, :PROMPT])
    logits, cache = jm.prefill(jp, {"tokens": prompts}, CACHE_LEN)
    toks = [jnp.argmax(logits, axis=-1)]
    for _ in range(DECODE_STEPS):
        logits, cache = jm.decode_step(jp, toks[-1], cache)
        toks.append(jnp.argmax(logits, axis=-1))
    return np.asarray(jnp.concatenate(toks, axis=1)), np.asarray(logits)


@functools.lru_cache(maxsize=1)
def _plain_greedy():
    model, params, _ = _dense_plain()
    prompts = torch.from_numpy(_batch("gemma3-1b")["tokens"][:, :PROMPT])
    with torch.no_grad():
        toks, logits, _ = _greedy(model, params, prompts)
    return toks.numpy(), logits.numpy()


def _assert_decode_ranks(ranks, model_ranks):
    """The ranks' greedy tokens on the cache sequence-sharded over
    ``model_ranks``, read back in batch order, identical to one process
    and to the JAX package; the last step's logits within 2e-4 of both."""
    for got in ranks:
        assert int(got["decode_block"]) == CACHE_LEN // model_ranks
    toks = np.zeros((BATCH, 1 + DECODE_STEPS), np.int64)
    logits = np.zeros((BATCH,) + ranks[0]["decode_logits"].shape[1:],
                      np.float32)
    for got in ranks:
        toks[got["decode_rows"]] = got["decode_tokens"]
        logits[got["decode_rows"]] = got["decode_logits"]
    for want_toks, want_logits in (_plain_greedy(), _jax_greedy()):
        np.testing.assert_array_equal(toks, want_toks)
        np.testing.assert_allclose(logits, want_logits, rtol=0, atol=2e-4)


def _assert_dense_ranks(ranks, model_ranks):
    """Against the JAX package's one-device step and the port's plain
    one-process step; the served tokens against both."""
    _assert_ranks_equal_plain(ranks, *_jax_loss_and_grads("gemma3-1b"))
    _assert_ranks_equal_plain(ranks, *_dense_plain()[2])
    _assert_decode_ranks(ranks, model_ranks)


def test_dense_world_4_equals_one_process(dense_world):
    _assert_dense_ranks(dense_world[1], model_ranks=2)


def test_dense_multi_pod_world_4_equals_one_process(tmp_path):
    """(pod 2, data 2, model 1): the batch over pod × data, pod-major."""
    _assert_dense_ranks(_run_dense(tmp_path, "2,2,1"), model_ranks=1)


def test_world_4_checkpoint_restores_at_world_1_bitwise(dense_world):
    from repro_torch.training import init_opt_state, restore_checkpoint
    from repro_torch.tree import flatten_with_path, path_key
    out, ranks = dense_world
    model, params, _ = _dense_plain()
    back = restore_checkpoint(str(out / "ckpt.npz"),
                              {"params": params,
                               "opt": init_opt_state(params)})
    stepped = _by_prefix(ranks[0], "param/")
    n = 0
    for p, t in flatten_with_path(back["params"]):
        np.testing.assert_array_equal(t.numpy(), stepped[path_key(p)])
        n += 1
    assert n == len(stepped) and int(back["opt"].step) == 1


def test_moe_world_4_equals_jax_package(tmp_path):
    """grok-1 smoke on (data 2, model 2): each rank routes its block as
    one group, holds its block of the experts (2 of 4, and half of each
    one's d_ff) and trades the dispatched tokens with the other data rank
    by all-to-all (the gradients meet the JAX package's only if each
    rank's tokens reach and return from the rank holding their experts),
    and the aux loss is global, as the JAX package's one-device step with
    ``moe_groups = 2``."""
    from repro_torch.configs import smoke_config
    ranks = _start_step_ranks(tmp_path, "grok-1-314b", "2,2")
    try:
        loss, want = _jax_loss_and_grads("grok-1-314b", 2)
    finally:
        _wait_ranks(ranks)
    got = _ranks_npz(tmp_path, 4)
    _assert_ranks_equal_plain(got, loss, want)
    cfg = smoke_config("grok-1-314b")
    L, E, d, ff = cfg.num_layers, cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    for r in got:
        assert tuple(r["held/w_gate"]) == tuple(r["held/w_up"]) == (
            L, E // 2, d, ff // 2)
        assert tuple(r["held/w_down"]) == (L, E // 2, ff // 2, d)


def _step_losses(stdout: str) -> list:
    return [float(m) for m in re.findall(r"^step +\d+ loss (\S+)", stdout,
                                         re.M)]


def test_launcher_world_4_losses_equal_world_1(tmp_path):
    """``--production --smoke --device cpu --dtype float32`` (remat) on
    (2, 2) as four ranks: rank 0 alone prints, its first line names the
    mesh and the world, and its 3 losses are the world-1 run's within
    2e-4; its greedy tokens after them (``--decode-steps 4``, on the cache
    sequence-sharded over "model") are the world-1 run's. (In bf16 the
    ranks' gradients are summed in bf16 by the reduce-scatter, one
    rounding more than one process takes.)"""
    from repro_torch.launch import train as launcher
    argv = ["--production", "--smoke", "--device", "cpu", "--dtype",
            "float32", "--steps", "3", "--batch-size", str(BATCH),
            "--seq-len", str(SEQ), "--decode-steps", "4"]
    ranks = _start_ranks(tmp_path, 4, [
        "-m", "repro_torch.launch.train", *argv, "--mesh", "2,2",
        "--init-method", (tmp_path / "pg").as_uri(),
        "--pg-timeout-s", str(PG_TIMEOUT_S)])
    try:
        one = launcher.main(argv)
    finally:
        outs = _wait_ranks(ranks)
    want = one["losses"]
    assert "mesh={'data': 2, 'model': 2} world=4" in outs[0].splitlines()[0]
    assert not any(outs[1:]), outs[1:]
    got = _step_losses(outs[0])
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert abs(a - b) <= LOSS_TOL, (got, want)
    tokens = re.findall(r"^decode tokens=(\S+)$", outs[0], re.M)
    assert tokens == [",".join(str(int(t))
                               for t in one["decoded"].reshape(-1))]
    assert one["decoded"].shape == (BATCH, 5)


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------

class _Mesh:
    """A described mesh that knows this rank's coordinates."""

    def __init__(self, shape, coord):
        self.mesh_dim_names = tuple(shape)
        self.shape = tuple(shape.values())
        self._coord = list(coord)

    def get_coordinate(self):
        return self._coord


def test_remat_recompute_keeps_the_hints_on_another_thread():
    """A remat step recomputes each layer in its backward, and on CUDA the
    autograd engine runs that backward on a thread of its own, where the
    forward's hints are not set. Here the backward runs on another
    thread: grok-1 smoke under ``moe_groups = 2`` gives the same
    gradients with remat as without (a recompute without the hints would
    route one group, with another capacity)."""
    import threading

    from repro_torch.configs import smoke_config
    from repro_torch.distributed.hints import activation_sharding
    from repro_torch.models import Model
    from repro_torch.training import batch_to_device
    from repro_torch.tree import leaves
    cfg = smoke_config("grok-1-314b")
    grads = {}
    for remat in (False, True):
        model = Model(cfg, param_dtype=torch.float32, device="cpu",
                      remat=remat)
        params = model.init(torch.Generator().manual_seed(3))
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        batch = batch_to_device(_batch("grok-1-314b"), model)
        with activation_sharding({"moe_groups": 2}):
            loss = model.loss(params, batch)
        out = {}

        def backward():
            try:
                out["grads"] = torch.autograd.grad(loss, flat,
                                                   allow_unused=True)
            except Exception as e:      # raised again on this thread
                out["error"] = e

        t = threading.Thread(target=backward)
        t.start()
        t.join(RUN_TIMEOUT_S)
        if "error" in out:
            raise out["error"]
        grads[remat] = out["grads"]
    assert len(grads[True]) == len(grads[False])
    for a, b in zip(grads[False], grads[True]):
        assert (a is None and b is None) or torch.equal(a, b)


def test_local_block_is_pod_major():
    """Over (pod, data) the blocks, read in rank order, are the batch's
    rows in order, as the reference's ``P(("pod", "data"))``; the model
    axis does not split the batch."""
    from repro_torch.distributed.sharding import NamedSharding, local_block
    t = torch.arange(8 * 3).reshape(8, 3)
    shape = {"pod": 2, "data": 2, "model": 2}
    blocks = []
    for pod in range(2):
        for data in range(2):
            for model in range(2):
                mesh = _Mesh(shape, (pod, data, model))
                blocks.append(local_block(
                    t, NamedSharding(mesh, (("pod", "data"), None))))
    for i in range(0, 8, 2):
        assert torch.equal(blocks[i], blocks[i + 1])      # model ranks
    assert torch.equal(torch.cat(blocks[::2]), t)
    whole = local_block(t, NamedSharding(_Mesh(shape, (1, 0, 1)),
                                         (None, None)))
    assert torch.equal(whole, t)
    with pytest.raises(ValueError, match="divide"):
        local_block(t[:6], NamedSharding(_Mesh(shape, (0, 0, 0)),
                                         (("pod", "data"), None)))


def test_mesh_and_device_checks(monkeypatch):
    from repro_torch.launch import mesh, train
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(ValueError, match="LOCAL_RANK 1"):
        mesh.rank_device(torch.device("cuda"))
    assert mesh.rank_device(torch.device("cpu")) == torch.device("cpu")
    assert train._mesh_shape("", True) == {"pod": 1, "data": 1, "model": 1}
    assert train._mesh_shape("4,2", False) == {"data": 4, "model": 2}
    with pytest.raises(ValueError, match="3 sizes"):
        train._mesh_shape("4,2", True)


def test_launcher_world_1_refuses_a_larger_mesh():
    """A mesh whose size is not the world's raises (the world of 1 the
    launcher started is destroyed)."""
    import torch.distributed as dist
    from repro_torch.launch import train as launcher
    with pytest.raises(ValueError, match="needs 4 ranks; the world has 1"):
        launcher.main(["--production", "--smoke", "--device", "cpu",
                       "--steps", "1", "--mesh", "2,2"])
    assert not dist.is_initialized()


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1:]))
