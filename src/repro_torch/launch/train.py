"""Training launcher: the counterpart of the JAX package's
``launch/train.py``.

Smoke mode (default): the reduced config of ``--arch`` in fp32, real
optimization steps on the synthetic LM pipeline, with checkpointing.

Production mode (``--production``): the full config in bf16 (``--dtype``)
with remat, on a ``DeviceMesh`` of ``--mesh`` (data, model) — (pod, data,
model) with ``--multi-pod`` — over a world of that many processes, one a
rank (``launch/mesh.py``: the world starts from ``--init-method`` or from
``torchrun``'s environment; by default it is one process on the (1, 1)
mesh). Params and optimizer state are DTensors placed by
``distributed/sharding.py``'s rules, each weight gathered at use over the
data / pod axes (ZeRO-3, a layer at a time), the MoE experts parallel
over those axes where they divide them, and the FFN and the vocabulary
tensor-parallel over "model", the hints set as the reference sets them.
Every rank draws the same global batch from the seed and the step keeps
its block over the fsdp axes, as the reference's ``P(bspec, None)`` (the
whole batch when it does not divide them); the gradients are summed
across those ranks (``training/train_loop.py``). Rank 0 alone prints. ``--smoke`` runs
production mode on the reduced config (the CPU tests' size).
``--decode-steps N`` then serves the trained params on the same mesh: the
first half of each row of the next batch as its prompt, prefilled into a
cache of ``--seq-len`` positions that ``cache_shardings`` places (the
sequence over "model"), and N greedy decode steps on it; rank 0 prints the
tokens of the whole batch.

Runs on the current CUDA device (``cuda:LOCAL_RANK`` in a world) unless
``--device`` names another; with neither a flag nor a GPU it raises.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b --steps 100
  PYTHONPATH=src python -m repro_torch.launch.train --production --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 3
  # four processes on one host (on CUDA: one card each)
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --production --mesh 2,2 --steps 3
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.distributed.hints import activation_sharding
from repro_torch.distributed.sharding import axis_sizes
from repro_torch.launch.mesh import (AXES, MULTI_POD_AXES,
                                     ensure_process_group, make_mesh,
                                     production_state, rank_device)
from repro_torch.models import Model
from repro_torch.training import (DataConfig, OptimizerConfig,
                                  SyntheticLM, batch_to_device,
                                  init_opt_state, make_train_step,
                                  save_checkpoint)
from repro_torch.tree import leaves


def _mesh_shape(text: str, multi_pod: bool) -> Dict[str, int]:
    names = MULTI_POD_AXES if multi_pod else AXES
    if not text:
        return dict.fromkeys(names, 1)
    sizes = [int(n) for n in text.split(",")]
    if len(sizes) != len(names):
        raise ValueError(f"--mesh {text}: {len(names)} sizes "
                         f"({','.join(names)})")
    return dict(zip(names, sizes))


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="gemma3-1b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--production", action="store_true",
                    help="full config, bf16, remat, on a DeviceMesh")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --production: the mesh has a pod axis")
    ap.add_argument("--mesh", default="",
                    help="with --production: the axis sizes, 'data,model' "
                         "('pod,data,model' with --multi-pod), their "
                         "product the world size (default all ones)")
    ap.add_argument("--init-method", default=None,
                    help="with --production: the process group's "
                         "rendezvous (e.g. file:///tmp/pg; RANK and "
                         "WORLD_SIZE from the environment); default "
                         "torchrun's environment, else a world of 1")
    ap.add_argument("--pg-timeout-s", type=float, default=None,
                    help="with --production: the process group's timeout")
    ap.add_argument("--smoke", action="store_true",
                    help="with --production: the reduced config")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16",
                    help="with --production: the params' dtype")
    ap.add_argument("--decode-steps", type=int, default=0,
                    help="with --production: greedy decode steps after "
                         "training, on the mesh's sequence-sharded cache")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device; "
                         "'cpu' runs the plain PyTorch path)")
    args = ap.parse_args(argv)
    device = rank_device(resolve_device(args.device))

    if args.production:
        cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
        dtype = getattr(torch, args.dtype)
    else:
        cfg = smoke_config(args.arch)
        dtype = torch.float32
    started = False
    if args.production:
        shape = _mesh_shape(args.mesh, args.multi_pod)
        started = ensure_process_group(device.type, args.init_method,
                                       args.pg_timeout_s)
    try:
        model = Model(cfg, param_dtype=dtype, device=device,
                      remat=args.production)
        opt_cfg = OptimizerConfig(lr=args.lr,
                                  warmup_steps=max(args.steps // 10, 1),
                                  total_steps=args.steps)
        data = SyntheticLM(cfg, DataConfig(batch_size=args.batch_size,
                                           seq_len=args.seq_len))
        params = model.init(torch.Generator(device=device).manual_seed(0))
        world, rank = 1, 0
        if args.production:
            mesh = make_mesh(shape, device.type)
            params, opt_state, hints = production_state(
                model, params, mesh, args.batch_size)
            mesh_desc = axis_sizes(mesh)
            world = torch.distributed.get_world_size()
            rank = torch.distributed.get_rank()
        else:
            opt_state = init_opt_state(params)
            hints, mesh_desc = {}, None
        say = print if rank == 0 else (lambda *a, **k: None)
        step = make_train_step(model, opt_cfg)
        n_params = sum(p.numel() for p in leaves(params))
        say(f"arch={cfg.name} params={n_params / 1e6:.1f}M "
            f"mesh={mesh_desc} world={world} "
            f"dtype={str(dtype).split('.')[-1]} device={device}", flush=True)
        it = iter(data)
        losses, step_ms = [], []
        t0 = time.perf_counter()
        with activation_sharding(hints):
            for s in range(1, args.steps + 1):
                batch = batch_to_device(next(it), model)
                ts = time.perf_counter()
                params, opt_state, metrics = step(params, opt_state, batch)
                losses.append(float(metrics["loss"]))   # waits for the step
                step_ms.append((time.perf_counter() - ts) * 1e3)
                if s % max(args.steps // 10, 1) == 0 or s == 1:
                    say(f"step {s:5d} loss {losses[-1]:.6f} "
                        f"lr {float(metrics['lr']):.2e} "
                        f"ms {step_ms[-1]:.1f}", flush=True)
            wall = time.perf_counter() - t0
            decoded = None
            if args.production and args.decode_steps:
                prompts = batch_to_device(next(it), model)["tokens"]
                decoded = serve_greedy(model, params, mesh, prompts[
                    :, :args.seq_len // 2], args.seq_len, args.decode_steps)
        say(f"{args.steps} steps in {wall:.1f}s "
            f"({wall / args.steps * 1e3:.0f} ms/step host wall)")
        if decoded is not None:
            say("decode tokens=" + ",".join(
                str(int(t)) for t in decoded.reshape(-1)), flush=True)
        if args.checkpoint:
            save_checkpoint(args.checkpoint,
                            {"params": params, "opt": opt_state},
                            step=args.steps)
            say(f"checkpoint: {args.checkpoint}")
    finally:
        if started:
            torch.distributed.destroy_process_group()
    return {"losses": losses, "step_ms": step_ms, "wall_s": wall,
            "params": params, "opt_state": opt_state, "decoded": decoded}


@torch.no_grad()
def serve_greedy(model: Model, params: Any, mesh: Any,
                 prompts: torch.Tensor, cache_len: int,
                 steps: int) -> torch.Tensor:
    """Greedy decoding of the global ``prompts`` [B, P] on ``mesh`` under
    the production hints: each rank prefills its block of the batch into
    the cache ``cache_shardings`` places (each "model" rank keeping its
    sequence block), then ``steps`` decode steps on it, each weight
    gathered at use (a layer's where the layer runs). Returns every rank
    the whole batch's tokens [B, 1 + steps] (the prefill's token
    first)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.configs.base import InputShape
    from repro_torch.distributed.sharding import (batch_shardings,
                                                  local_block)
    B, P = prompts.shape
    tok_sh = batch_shardings(model, InputShape("prompt", P, B, "prefill"),
                             mesh)["tokens"]
    c_sh = batch_shardings(model, InputShape("cache", cache_len, B,
                                             "decode"), mesh)["cache"]
    logits, cache = model.prefill(params, {"tokens": local_block(prompts,
                                                                 tok_sh)},
                                  cache_len, cache_shardings=c_sh)
    toks = [logits.argmax(-1)]
    for _ in range(steps):
        logits, cache = model.decode_step(params, toks[-1], cache)
        toks.append(logits.argmax(-1))
    block = torch.cat(toks, dim=1).contiguous()
    return DTensor.from_local(block, mesh, tok_sh.placements,
                              run_check=False).full_tensor()


if __name__ == "__main__":
    main()
