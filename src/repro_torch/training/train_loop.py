"""Training loop: the step function and the loop, the counterpart of the JAX
package's ``training/train_loop.py``.

``make_train_step`` returns a (params, opt_state, batch) -> (params,
opt_state, metrics) function: the loss and its gradients
(``loss_and_grads``, by ``torch.autograd.grad`` over the param leaves: the
reference's ``jax.value_and_grad``), then ``adamw_update`` under
``no_grad``, in place (the reference's ``donate_argnums``). The step runs
eagerly. With DTensor params (``--production``) the model gathers each
weight at use, a layer's inside the layer's body (``models/transformer.
py``), and its gradient comes back in the param's placements.

The step takes the global batch on every rank. On a mesh whose ranks
split the batch (the ``"btd"`` hint's axes, ``sharding.batch_axes``) each
rank keeps its block of it (``sharding.batch_block``); its loss term is
its CE sum over the global target count plus its share (1 / D) of the
global aux loss; the gather's backward sums the data ranks' gradients, so
every weight gets the global batch's gradient, and the reported loss is
summed over those ranks. With the batch whole on every rank (one process,
a one-rank mesh) the step is the plain one.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike
from repro_torch.distributed.sharding import (_axis_size, all_reduce_sum,
                                              batch_axes, batch_block)
from repro_torch.models.model import Model
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.optimizer import (OptimizerConfig, OptState,
                                            adamw_update, init_opt_state)
from repro_torch.tree import leaves, tree_map


def batch_to_device(batch: Dict[str, Any], model: Model,
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """A numpy (or tensor) batch as tensors on ``device`` (default the
    model's). Integer arrays keep their dtype; float inputs (patch
    embeddings, frames) take the param dtype, which torch's matmuls need."""
    dev = device if device is not None else model.device
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v)) if not isinstance(
            v, torch.Tensor) else v
        if t.is_floating_point():
            t = t.to(model.dtype)
        out[k] = t.to(dev)
    return out


def _rank_loss(model: Model, params: Any, batch: Dict[str, torch.Tensor],
               mesh: Any, axes) -> torch.Tensor:
    """This rank's term of the global loss, its block of the batch on the
    ranks of ``axes``: the terms summed over those ranks are the loss of
    the whole batch, and so are their gradients (the aux loss is already
    global on every rank, ``moe.route``; its all-reduce sums the
    gradients in its backward, so each rank takes 1 / D of it)."""
    tot, cnt, aux = model.loss_terms(params, batch)
    count = all_reduce_sum(cnt, mesh, axes)
    loss = tot / torch.clamp(count, min=1.0)
    if model.cfg.has_moe:
        loss = loss + (model.cfg.moe.aux_loss_weight * aux
                       / _axis_size(mesh, axes))
    return loss


def loss_and_grads(model: Model, params: Any, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Any]:
    """(the loss, its gradient tree) at ``params`` on the global
    ``batch``: on a mesh whose ranks split the batch, each rank computes
    on its block and gets the global batch's loss and gradient (module
    doc), the gradients in the params' placements."""
    mesh, axes = batch_axes()
    batch = batch_block(batch)
    flat = leaves(params)
    with torch.enable_grad():
        for p in flat:
            p.requires_grad_(True)
        try:
            loss = (_rank_loss(model, params, batch, mesh, axes) if axes
                    else model.loss(params, batch))
            # a leaf the family never reads (an SSM layer's ln2) gets
            # zeros, as under jax.grad
            grads_flat = torch.autograd.grad(loss, flat, allow_unused=True)
        finally:
            for p in flat:
                p.requires_grad_(False)
    loss = loss.detach()
    if axes:
        loss = all_reduce_sum(loss, mesh, axes)
    by_id = {id(p): (torch.zeros_like(p) if g is None else g)
             for p, g in zip(flat, grads_flat)}
    return loss, tree_map(lambda p: by_id[id(p)], params)


def make_train_step(model: Model, opt_cfg: OptimizerConfig
                    ) -> Callable[[Any, OptState, Dict[str, torch.Tensor]],
                                  Tuple[Any, OptState,
                                        Dict[str, torch.Tensor]]]:
    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(model, params, batch)
        params, opt_state, metrics = adamw_update(opt_cfg, params, grads,
                                                  opt_state)
        return params, opt_state, dict(metrics, loss=loss)

    return train_step


def train(model: Model, data: Iterable[Dict[str, Any]], steps: int, *,
          opt_cfg: Optional[OptimizerConfig] = None,
          generator: Optional[torch.Generator] = None,
          log_every: int = 10,
          checkpoint_path: Optional[str] = None,
          checkpoint_every: int = 0,
          log_fn: Callable[[str], None] = print,
          device: DeviceLike = None,
          params: Optional[Any] = None) -> Dict[str, Any]:
    """Smoke-scale training loop (one process): ``params`` (default: fresh
    from ``generator``, itself by default seed 0 on the model's device),
    ``steps`` steps over ``data``'s batches (moved to ``device``, default
    the model's)."""
    opt_cfg = opt_cfg or OptimizerConfig(total_steps=steps)
    if params is None:
        if generator is None:
            generator = torch.Generator(device=model.device).manual_seed(0)
        params = model.init(generator)
    opt_state = init_opt_state(params)
    step_fn = make_train_step(model, opt_cfg)

    it = iter(data)
    losses = []
    t0 = time.perf_counter()
    for step in range(1, steps + 1):
        batch = batch_to_device(next(it), model, device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if log_every and step % log_every == 0:
            log_fn(f"step {step:5d} loss {losses[-1]:.4f} "
                   f"lr {float(metrics['lr']):.2e} "
                   f"gnorm {float(metrics['grad_norm']):.2f}")
        if checkpoint_path and checkpoint_every \
                and step % checkpoint_every == 0:
            save_checkpoint(checkpoint_path,
                            {"params": params, "opt": opt_state}, step=step)
    wall = time.perf_counter() - t0
    return {"params": params, "opt_state": opt_state, "losses": losses,
            "wall_s": wall}


__all__ = ["batch_to_device", "loss_and_grads", "make_train_step",
           "train"]
