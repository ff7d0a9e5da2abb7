"""Seeded weights in the port's parameter layout, made on the device.

Every leaf of every tenant is a view into one flat buffer per dtype, filled
by one ``normal_`` call from a ``torch.Generator`` on the device and scaled
leaf by leaf: a few large calls, in the dtype the weights are served in,
never through the host. The layout is the port's (``models/model.py``):
stacked ``[L, ...]`` blocks, ``attn`` wq / wk / wv / wo, a gated ``mlp`` or
an ``moe`` (an fp32 router [L, d, E] and experts [L, E, ...]), untied
``embed`` / ``unembed``. The norms' gammas are drawn too (small), so a
norm that drops its scale shows.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], float, torch.dtype]


def leaves(model: Dict, dtype: torch.dtype) -> List[Leaf]:
    """(path, shape, std, dtype) of every leaf of one weight set."""
    d, L, V = model["hidden_size"], model["num_hidden_layers"], \
        model["vocab_size"]
    hd, H, Hkv = model["head_dim"], model["num_attention_heads"], \
        model["num_key_value_heads"]
    dff = model["intermediate_size"]
    out: List[Leaf] = [
        (("embed",), (V, d), 0.02, dtype),
        (("unembed",), (d, V), 0.02, dtype),
        (("final_norm",), (d,), 0.1, dtype),
        (("blocks", "ln1"), (L, d), 0.1, dtype),
        (("blocks", "ln2"), (L, d), 0.1, dtype),
        (("blocks", "attn", "wq"), (L, d, H * hd), d ** -0.5, dtype),
        (("blocks", "attn", "wk"), (L, d, Hkv * hd), d ** -0.5, dtype),
        (("blocks", "attn", "wv"), (L, d, Hkv * hd), d ** -0.5, dtype),
        (("blocks", "attn", "wo"), (L, H * hd, d), (H * hd) ** -0.5, dtype),
    ]
    moe = model.get("moe")
    if moe:
        E = moe["num_local_experts"]
        out += [
            (("blocks", "moe", "router"), (L, d, E), d ** -0.5,
             torch.float32),
            (("blocks", "moe", "w_gate"), (L, E, d, dff), d ** -0.5, dtype),
            (("blocks", "moe", "w_up"), (L, E, d, dff), d ** -0.5, dtype),
            (("blocks", "moe", "w_down"), (L, E, dff, d), dff ** -0.5,
             dtype),
        ]
    else:
        out += [
            (("blocks", "mlp", "w_gate"), (L, d, dff), d ** -0.5, dtype),
            (("blocks", "mlp", "w_up"), (L, d, dff), d ** -0.5, dtype),
            (("blocks", "mlp", "w_down"), (L, dff, d), dff ** -0.5, dtype),
        ]
    return out


def make(model: Dict, seed: int, sets: int, device: torch.device,
         dtype: torch.dtype = torch.bfloat16) -> List[Dict]:
    """``sets`` independent weight sets (one per tenant variant) from
    ``seed``: one flat buffer and one ``normal_`` per dtype."""
    spec = leaves(model, dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & (2**63 - 1))
    sizes: Dict[torch.dtype, int] = {}
    for _, shape, _, dt in spec:
        sizes[dt] = sizes.get(dt, 0) + sets * math.prod(shape)
    flats = {}
    for dt, n in sizes.items():
        flats[dt] = torch.empty(n, dtype=dt, device=device).normal_(
            generator=gen)
    offsets = {dt: 0 for dt in sizes}
    trees: List[Dict] = []
    for _ in range(sets):
        tree: Dict = {}
        for path, shape, std, dt in spec:
            n = math.prod(shape)
            leaf = flats[dt][offsets[dt]:offsets[dt] + n].view(shape)
            offsets[dt] += n
            leaf.mul_(std)
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = leaf
        trees.append(tree)
    return trees


def nbytes(tree: Dict) -> int:
    total = 0
    for v in tree.values():
        total += nbytes(v) if isinstance(v, dict) else v.numel() * \
            v.element_size()
    return total
