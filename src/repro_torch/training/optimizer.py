"""AdamW with cosine schedule, warmup and global-norm clipping: the
counterpart of the JAX package's ``training/optimizer.py``.

The state lives in fp32 whatever the param dtype (bf16 training), and the
arithmetic is the reference's, in fp32 tensors on the params' device, in
the same order. The update is in place: params and moments are written
into their own storage (the reference's ``donate_argnums``), and the new
params are cast back to their dtype. A DTensor leaf (``--production``) is
updated shard by shard; only the gradient norm reduces across shards.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.distributed.sharding import full, local
from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor        # int32 scalar
    mu: Any
    nu: Any


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), fp32."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, decay)


def init_opt_state(params: Any) -> OptState:
    """Zero fp32 moments shaped (and, for DTensors, placed) like the
    params; step 0 on the params' device."""
    first = leaves(params)[0]
    device = local(first).device

    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)

    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the fp32 sum of squares over the leaves, added in JAX's
    flatten order (dict keys sorted). A DTensor leaf's sum is reduced
    across its shards."""
    total = 0
    for leaf in leaves(tree):
        total = total + full(torch.sum(torch.square(leaf.float())))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, params: Any, grads: Any,
                 state: OptState
                 ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place. Returns (params, the new OptState,
    {"grad_norm": the raw norm, "lr"}). Weight decay on ndim >= 2 only."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_at(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=stepf.device), stepf)

    def upd(p, g, mu, nu):
        p_l, mu_l, nu_l = local(p), local(mu), local(nu)
        g = local(g).float() * scale
        mu_l.mul_(cfg.b1).add_((1.0 - cfg.b1) * g)
        nu_l.mul_(cfg.b2).add_((1.0 - cfg.b2) * g * g)
        delta = (mu_l / b1c) / (torch.sqrt(nu_l / b2c) + cfg.eps)
        # decoupled weight decay on matrices only (ndim >= 2)
        if p.ndim >= 2:
            delta = delta + cfg.weight_decay * p_l.float()
        p_l.copy_(p_l.float() - lr * delta)
        return p

    tree_map(upd, params, grads, state.mu, state.nu)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(step, state.mu, state.nu), metrics


__all__ = ["OptState", "OptimizerConfig", "adamw_update", "global_norm",
           "init_opt_state", "lr_at"]
