"""Mixture-of-experts FFN with sort-based capacity dispatch.

The counterpart of the JAX package's ``models/moe.py``. Dispatch is
SORT-based: assignments are sorted by expert (a stable sort), ranked within
their expert, and scattered into a dense [E, C, d] buffer; tokens past an
expert's capacity C are dropped (GShard semantics) and the combine step
zeroes their contribution, so the residual stream still carries them.

Expert compute is three einsums over that buffer here, outside any kernel,
as in the JAX package; the JIT's MoE templates (core/jit.py) replace them
with per-expert GEMMs on the ``coalesced_gemm`` kernel and run the same
route / dispatch / combine functions as glue.

Params are stacked on a leading layer axis, as everywhere in this package:
``init_moe`` returns ``router`` [L, d, E] (fp32), ``w_gate`` / ``w_up``
[L, E, d, d_ff] and ``w_down`` [L, E, d_ff, d]; the functions below take
one layer's slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import Params, dense_init_


def init_moe(num_layers: int, d_model: int, d_ff: int, cfg: MoEConfig,
             dtype: torch.dtype, device: torch.device,
             generator: torch.Generator) -> Params:
    """Stacked MoE params of ``num_layers`` layers, drawn from
    ``generator``. The router stays fp32, as in the JAX package."""
    L, E = num_layers, cfg.num_experts

    def empty(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=device)

    g = generator
    return {
        "router": dense_init_(empty(L, d_model, E, dt=torch.float32), g),
        "w_gate": dense_init_(empty(L, E, d_model, d_ff), g),
        "w_up": dense_init_(empty(L, E, d_model, d_ff), g),
        "w_down": dense_init_(empty(L, E, d_ff, d_model), g),
    }


def capacity(num_tokens: int, cfg: MoEConfig) -> int:
    """Slots an expert holds for ``num_tokens`` routed tokens: the JAX
    package's ``int(...)`` truncation, floored at ``top_k``."""
    c = int(num_tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(c, cfg.top_k)


def route(router: torch.Tensor, x: torch.Tensor, cfg: MoEConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing. x: [T, d] -> (weights [T, k], experts [T, k] int64,
    aux_loss).

    ``jax.lax.top_k`` breaks ties toward the lower expert index;
    ``torch.topk`` promises no order among equal values. A stable
    descending sort keeps equal probabilities in index order, so its first
    k columns are the JAX package's choice, ties included.

    The aux loss is over all the batch's tokens, as in the JAX package: on
    a rank that holds a block of the batch (``sharding.batch_axes``),
    ``frac`` and ``mean_p`` are averaged over the ranks of those axes
    before the product (the all-reduce of ``mean_p`` is differentiable),
    so every such rank holds the global aux loss."""
    from repro_torch.distributed.sharding import (_axis_size, all_reduce_sum,
                                                  batch_axes)
    logits = x.float() @ router                         # [T, E]
    probs = torch.softmax(logits, dim=-1)
    weights, experts = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
    weights, experts = weights[:, :cfg.top_k], experts[:, :cfg.top_k]
    weights = weights / weights.sum(dim=-1, keepdim=True)
    # load-balancing aux loss (Switch-style): E * sum_e f_e * p_e
    one_hot = F.one_hot(experts[:, 0], cfg.num_experts).float()
    frac = one_hot.mean(dim=0)
    mean_p = probs.mean(dim=0)
    mesh, axes = batch_axes()
    if axes:
        n = _axis_size(mesh, axes)
        frac = all_reduce_sum(frac, mesh, axes) / n
        mean_p = all_reduce_sum(mean_p, mesh, axes, differentiable=True) / n
    aux = cfg.num_experts * torch.sum(frac * mean_p)
    return weights, experts, aux


def dispatch_tokens(x: torch.Tensor, weights: torch.Tensor,
                    experts: torch.Tensor, E: int, k: int, C: int):
    """Sort-based dispatch of one token group. x: [T, d] -> (buf [E, C, d],
    meta). ``weights`` is unused here (the combine reads it); the signature
    follows the JAX package's ``dispatch_tokens``."""
    T, d = x.shape
    dev = x.device
    e_flat = experts.reshape(-1)                        # [T*k]
    tok_of = torch.arange(T * k, device=dev) // k       # assignment -> token
    order = torch.argsort(e_flat, stable=True)          # [T*k]
    sorted_e = e_flat[order]
    sorted_tok = tok_of[order]
    # rank of each assignment within its expert. Every shape here is fixed
    # by (T, k, E, C), never by the routing, so nothing waits on the card
    # and a CUDA graph can hold the step: counts by an integer scatter-add
    # (exact in any order), not ``bincount``, whose output size is read
    # back from the data
    counts = torch.zeros(E, dtype=sorted_e.dtype, device=dev).scatter_add_(
        0, sorted_e, torch.ones_like(sorted_e))
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1]])
    rank = torch.arange(T * k, device=dev) - offsets[sorted_e]
    keep = rank < C
    # the JAX package writes dropped assignments to slot C, out of bounds,
    # with mode="drop"; here they land in an overflow row C of an
    # [E, C + 1, d] buffer that is sliced off
    slot = torch.where(keep, rank, torch.full_like(rank, C))
    buf = torch.zeros((E, C + 1, d), dtype=x.dtype, device=dev)
    # index_select, not x[...]: a token's k rows then add their gradients
    # in a fixed order (indexing's accumulate is atomic on the CPU)
    buf.index_put_((sorted_e, slot), x.index_select(0, sorted_tok))
    return buf[:, :C], (order, sorted_e, sorted_tok, keep, slot)


def combine_tokens(out_buf: torch.Tensor, w_flat: torch.Tensor, meta,
                   T: int, d: int) -> torch.Tensor:
    """Weighted combine of the expert outputs back to [T, d] (fp32).

    The JAX package scatter-adds the k contributions of each token
    (``.at[sorted_tok].add``). On CUDA ``index_add_`` is atomic and its
    order is not fixed, so here each token's k contributions are put back
    in assignment order and summed in that fixed order, from zero: the same
    bits on every run and device, and the JAX package's bits for
    top_k <= 2 (two fp32 terms add the same in either order)."""
    order, sorted_e, sorted_tok, keep, slot = meta
    k = int(order.shape[0]) // T
    gathered = out_buf[sorted_e, torch.where(keep, slot, torch.zeros_like(slot))]
    gathered = torch.where(keep[:, None], gathered,
                           torch.zeros_like(gathered))
    contrib = gathered.float() * w_flat[order][:, None]      # sorted order
    per_assign = torch.empty_like(contrib)
    per_assign[order] = contrib                              # t*k + j order
    per_assign = per_assign.reshape(T, k, d)
    y = torch.zeros((T, d), dtype=torch.float32, device=out_buf.device)
    for j in range(k):
        y = y + per_assign[:, j]
    return y


def expert_ffn_weights(moe_params: Params, e: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Expert ``e``'s (w_gate, w_up, w_down) slices of one layer's packs.
    Each call makes new view objects: a caller that feeds the dispatch
    executor takes them once, at template build (core/jit.py holds them
    through ``_stable_view``), since the executor's packed-weight cache
    guards on tensor identity."""
    return (moe_params["w_gate"][e], moe_params["w_up"][e],
            moe_params["w_down"][e])


def moe_ffn(params: Params, x: torch.Tensor, cfg: MoEConfig,
            groups: Optional[int] = None, d_ff: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN of one layer. x: [T, d] -> (y [T, d], aux_loss scalar).

    ``groups`` splits the tokens into independently routed groups
    (GShard-style), each with its own capacity. The default is the
    launcher's ``moe_groups`` hint (``distributed/hints.py``; the product
    of the mesh's data axes, 1 on one device), else 1, as in the JAX
    package; a group count that does not divide T falls back to 1. The
    hint counts the groups of the whole batch: a rank that holds a block
    of it (``sharding.batch_axes``) routes the groups of its block, the
    hint over the ranks of those axes (one group, T/D of the batch's
    tokens, when the hint is the data ranks D).

    Where the expert weights hold this rank's "model" block of ``d_ff``
    (``sharding.gather_at_use``), the expert einsums are the Megatron
    pair within each expert: ``copy_to_model`` of the dispatched buffer,
    the rank's d_ff block, ``reduce_from_model`` of the expert outputs.
    Routing, capacity and the groups are every "model" rank's alike.

    Where they hold this rank's block of the experts (expert parallelism
    over the axes that split the batch, ``sharding.expert_block``), the
    dispatched buffer [G, E, C, d] goes out by expert block, rank j
    getting ``buf[:, block j]`` (``sharding.exchange_experts``, one
    all-to-all); the rank runs its E/D experts on the [D·G, E/D, C, d]
    the D ranks sent it, and a second exchange sends each rank's slots
    back before the combine: the reference's [G, E, C, d] all-to-all."""
    from repro_torch.distributed.hints import static_hint
    from repro_torch.distributed.sharding import (_axis_size, batch_axes,
                                                  copy_to_model,
                                                  exchange_experts,
                                                  expert_block, model_block,
                                                  reduce_from_model)
    T, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    if groups is not None:
        G = groups
    else:
        G = int(static_hint("moe_groups", 1))
        mesh, axes = batch_axes()
        if axes:
            G = max(G // _axis_size(mesh, axes), 1)
    if T % G:
        G = 1
    Tg = T // G
    C = capacity(Tg, cfg)

    weights, experts, aux = route(params["router"], x, cfg)
    xg = x.reshape(G, Tg, d)
    wg = weights.reshape(G, Tg, k)
    eg = experts.reshape(G, Tg, k)
    bufs, metas = [], []
    for g in range(G):
        buf, meta = dispatch_tokens(xg[g], wg[g], eg[g], E, k, C)
        bufs.append(buf)
        metas.append(meta)
    buf = torch.stack(bufs)                                  # [G, E, C, d]
    ex, _ = expert_block(params["w_gate"], 0, E)
    if ex is not None:
        # [G, D, E/D, C, d] -> [D, G, ...]: block j to expert rank j
        D = ex.size
        buf = exchange_experts(buf.reshape(G, D, E // D, C, d)
                               .transpose(0, 1), ex)
        buf = buf.reshape(D * G, E // D, C, d)

    # the expert GEMMs: plain einsums here, as in the JAX package
    ax, _ = model_block(params["w_gate"], -1, d_ff)
    if ax is not None:
        buf = copy_to_model(buf, ax)
    gate = F.silu(torch.einsum("gecd,edf->gecf", buf, params["w_gate"]))
    up = torch.einsum("gecd,edf->gecf", buf, params["w_up"])
    out_buf = torch.einsum("gecf,efd->gecd", gate * up, params["w_down"])
    if ax is not None:
        out_buf = reduce_from_model(out_buf, ax)
    if ex is not None:
        out_buf = exchange_experts(out_buf.reshape(D, G, E // D, C, d), ex)
        out_buf = out_buf.transpose(0, 1).reshape(G, E, C, d)

    y = torch.stack([combine_tokens(out_buf[g], wg[g].reshape(-1), metas[g],
                                    Tg, d) for g in range(G)])
    return y.reshape(T, d).to(x.dtype), aux


__all__ = ["capacity", "combine_tokens", "dispatch_tokens",
           "expert_ffn_weights", "init_moe", "moe_ffn", "route"]
