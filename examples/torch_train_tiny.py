"""Train a reduced gemma3-family model on the PyTorch/CUDA port: a few
hundred steps on the synthetic LM pipeline, with checkpoints — the
training substrate (optimizer, data, checkpoint) end to end.

Run:  PYTHONPATH=src python examples/torch_train_tiny.py [--steps 200]
          [--arch gemma3-1b] [--ckpt PATH] [--device cpu]

Without ``--device`` it runs on the current CUDA card. The checkpoint goes
under ``build/`` (ignored by git) unless ``--ckpt`` names another path.
"""
import argparse
import dataclasses
from pathlib import Path

import torch

from repro_torch import resolve_device
from repro_torch.configs import smoke_config
from repro_torch.models import Model
from repro_torch.training import (DataConfig, OptimizerConfig, SyntheticLM,
                                  checkpoint_step, train)

DEFAULT_CKPT = Path(__file__).resolve().parents[1] / "build" / \
    "train_tiny.npz"


def main(argv=None, *, params=None):
    """Print the example's lines and return its results (losses, wall
    seconds ending in a synchronize, the checkpoint's path and step).
    ``params`` replaces the seeded init (the tests pass the JAX
    package's)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--ckpt", type=Path, default=DEFAULT_CKPT)
    ap.add_argument("--device", default=None,
                    help="cuda (default: the current card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = dataclasses.replace(smoke_config(args.arch), num_layers=2)
    model = Model(cfg, param_dtype=torch.float32, device=device)
    print(f"arch family: {args.arch} (reduced) — "
          f"{cfg.param_count() / 1e6:.2f}M params, on {device}")

    data = SyntheticLM(cfg, DataConfig(batch_size=8, seq_len=128, seed=0))
    args.ckpt.parent.mkdir(parents=True, exist_ok=True)
    ckpt = str(args.ckpt)
    res = train(model, data, steps=args.steps,
                opt_cfg=OptimizerConfig(lr=1e-3, warmup_steps=20,
                                        total_steps=args.steps),
                log_every=20, checkpoint_path=ckpt,
                checkpoint_every=max(args.steps // 2, 1), params=params)
    if device.type == "cuda":
        torch.cuda.synchronize()
    losses = res["losses"]
    n = max(1, min(10, len(losses) // 2))
    first = sum(losses[:n]) / n
    last = sum(losses[-n:]) / n
    print(f"\nloss: {first:.3f} -> {last:.3f} over {args.steps} steps "
          f"(means of the first and last {n}; {res['wall_s']:.1f} s wall)")
    step = checkpoint_step(ckpt)
    print(f"checkpoint at step {step}: {ckpt}")
    assert last < first, "training failed to reduce loss"
    return dict(device=str(device), losses=losses, first=first, last=last,
                wall_s=res["wall_s"], ckpt=ckpt, ckpt_step=step)


if __name__ == "__main__":
    main()
