"""Training launcher: the counterpart of the JAX package's
``launch/train.py``.

Smoke mode (default): the reduced config of ``--arch`` in fp32, real
optimization steps on the synthetic LM pipeline, with checkpointing.

Production mode (``--production``): the full config in bf16 with remat,
on the mesh of ``launch/mesh.py``: params and optimizer state are DTensors
placed by ``distributed/sharding.py``'s rules, each weight gathered at use
(ZeRO-3), the batch's hints set as the reference sets them. One process
drives one card, so the mesh is the (1, 1) host mesh ((1, 1, 1) with
``--multi-pod``); the placements are the rules', each mesh axis of size
1. ``--smoke`` runs production mode on the reduced config (the CPU tests'
size).

Runs on the current CUDA device unless ``--device`` names another; with
neither a flag nor a GPU it raises.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b --steps 100
  PYTHONPATH=src python -m repro_torch.launch.train --production --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 3
"""
from __future__ import annotations

import argparse
import math
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.distributed.hints import activation_sharding
from repro_torch.distributed.sharding import (NamedSharding, _fits,
                                              axis_sizes, distribute,
                                              fsdp_axes,
                                              opt_state_shardings,
                                              param_shardings)
from repro_torch.launch.mesh import ensure_process_group, make_host_mesh
from repro_torch.models import Model
from repro_torch.training import (DataConfig, OptimizerConfig, OptState,
                                  SyntheticLM, batch_to_device,
                                  init_opt_state, make_train_step,
                                  save_checkpoint)
from repro_torch.tree import leaves


def _production_state(model: Model, params: Any, mesh, batch_size: int):
    """Params and optimizer state placed on ``mesh`` by the sharding
    rules, and the activation hints the reference's launcher sets."""
    p_sh = param_shardings(model, mesh)
    opt_sh = opt_state_shardings(p_sh, mesh)
    opt = init_opt_state(params)
    opt = OptState(step=opt.step, mu=distribute(opt.mu, opt_sh.mu),
                   nu=distribute(opt.nu, opt_sh.nu))
    params = distribute(params, p_sh)
    dp = fsdp_axes(mesh)
    bspec = dp if _fits(mesh, batch_size, dp) else None
    hints: Dict[str, Any] = {"btd": NamedSharding(mesh, (bspec, None, None))}
    if model.cfg.has_moe:
        sizes = axis_sizes(mesh)
        hints["moe_groups"] = math.prod(sizes[a] for a in dp)
        hints["moe_tokens"] = NamedSharding(mesh, (bspec, None, None))
    return params, opt, hints


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="gemma3-1b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--production", action="store_true",
                    help="full config, bf16, remat, on the host DeviceMesh")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --production: the mesh has a pod axis")
    ap.add_argument("--smoke", action="store_true",
                    help="with --production: the reduced config")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device; "
                         "'cpu' runs the plain PyTorch path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.production:
        cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
        dtype = torch.bfloat16
    else:
        cfg = smoke_config(args.arch)
        dtype = torch.float32
    model = Model(cfg, param_dtype=dtype, device=device,
                  remat=args.production)
    opt_cfg = OptimizerConfig(lr=args.lr,
                              warmup_steps=max(args.steps // 10, 1),
                              total_steps=args.steps)
    data = SyntheticLM(cfg, DataConfig(batch_size=args.batch_size,
                                       seq_len=args.seq_len))
    params = model.init(torch.Generator(device=device).manual_seed(0))
    started = False
    try:
        if args.production:
            started = ensure_process_group(device.type)
            mesh = make_host_mesh(device.type, multi_pod=args.multi_pod)
            params, opt_state, hints = _production_state(
                model, params, mesh, args.batch_size)
            mesh_desc = axis_sizes(mesh)
        else:
            opt_state = init_opt_state(params)
            hints, mesh_desc = {}, None
        step = make_train_step(model, opt_cfg)
        n_params = sum(p.numel() for p in leaves(params))
        print(f"arch={cfg.name} params={n_params / 1e6:.1f}M "
              f"mesh={mesh_desc} dtype={str(dtype).split('.')[-1]} "
              f"device={device}", flush=True)
        it = iter(data)
        losses = []
        t0 = time.perf_counter()
        with activation_sharding(hints):
            for s in range(1, args.steps + 1):
                batch = batch_to_device(next(it), model)
                params, opt_state, metrics = step(params, opt_state, batch)
                losses.append(float(metrics["loss"]))
                if s % max(args.steps // 10, 1) == 0 or s == 1:
                    print(f"step {s:5d} loss {losses[-1]:.4f} "
                          f"lr {float(metrics['lr']):.2e}", flush=True)
        wall = time.perf_counter() - t0
        print(f"{args.steps} steps in {wall:.1f}s "
              f"({wall / args.steps * 1e3:.0f} ms/step host wall)")
        if args.checkpoint:
            save_checkpoint(args.checkpoint,
                            {"params": params, "opt": opt_state},
                            step=args.steps)
            print(f"checkpoint: {args.checkpoint}")
    finally:
        if started:
            torch.distributed.destroy_process_group()
    return {"losses": losses, "wall_s": wall, "params": params,
            "opt_state": opt_state}


if __name__ == "__main__":
    main()
