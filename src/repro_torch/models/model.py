"""Model facade: embedding + stack + LM head, with ``init``, ``init_cache``,
``prefill`` and ``decode_step``.

The counterpart of the JAX package's ``models/model.py`` for arch_type
"dense", "moe" and "ssm". The other families (hybrid, vlm, audio), the
int8 KV cache and the training entry points are not ported yet (ROADMAP
queue 1, items 12 and 13).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (ROPE_TABLE_POSITIONS, Params,
                                       dense_init_, embed_init_, rmsnorm)

Cache = Dict[str, Any]


# the families this package serves; the rest raise (ROADMAP queue 1)
PORTED_ARCHS = ("dense", "moe", "ssm")


class Model:
    """Functional model wrapper for one ``ModelConfig`` of a ported family
    (``PORTED_ARCHS``).

    Methods are functions of (params, inputs); the object holds the static
    configuration, the param dtype and the device. ``device`` defaults to
    the current CUDA device and raises when there is none.
    """

    def __init__(self, config: ModelConfig,
                 param_dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = None, kv_quant: bool = False):
        if config.arch_type not in PORTED_ARCHS:
            raise NotImplementedError(
                f"arch_type {config.arch_type!r} is not ported yet: the "
                f"port serves {', '.join(PORTED_ARCHS)} (ROADMAP queue 1 "
                f"item 12)")
        if kv_quant:
            raise NotImplementedError(
                "the int8 KV cache (kv_quant=True) is not ported yet "
                "(ROADMAP queue 1 item 12)")
        self.cfg = config
        self.dtype = param_dtype
        self.device = resolve_device(device)

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator) -> Params:
        """Random params at the config's widths, made on the model's device
        from ``generator`` (a ``torch.Generator`` on that device). The tree
        has the JAX package's keys, shapes and dtypes."""
        cfg = self.cfg
        L, d, hd, V = (cfg.num_layers, cfg.d_model, cfg.resolved_head_dim,
                       cfg.padded_vocab)

        def empty(*shape):
            return torch.empty(shape, dtype=self.dtype, device=self.device)

        def zeros(*shape):
            return torch.zeros(shape, dtype=self.dtype, device=self.device)

        g = generator
        params: Params = {
            "embed": embed_init_(empty(V, d), g),
            "final_norm": zeros(d),
        }
        if not cfg.tie_embeddings:
            params["unembed"] = embed_init_(empty(d, V), g)
        blocks: Params = {"ln1": zeros(L, d), "ln2": zeros(L, d)}
        if cfg.arch_type == "ssm":
            blocks["mamba"] = ssm_lib.init_mamba(L, d, cfg.ssm, self.dtype,
                                                 self.device, g)
        else:
            blocks["attn"] = {
                "wq": dense_init_(empty(L, d, cfg.num_heads * hd), g),
                "wk": dense_init_(empty(L, d, cfg.num_kv_heads * hd), g),
                "wv": dense_init_(empty(L, d, cfg.num_kv_heads * hd), g),
                "wo": dense_init_(empty(L, cfg.num_heads * hd, d), g),
            }
        if cfg.arch_type == "moe":
            blocks["moe"] = moe_lib.init_moe(L, d, cfg.d_ff, cfg.moe,
                                             self.dtype, self.device, g)
        elif cfg.arch_type == "dense":
            blocks["mlp"] = {
                "w_gate": dense_init_(empty(L, d, cfg.d_ff), g),
                "w_up": dense_init_(empty(L, d, cfg.d_ff), g),
                "w_down": dense_init_(empty(L, cfg.d_ff, d), g),
            }
        params["blocks"] = blocks
        return params

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        x = params["embed"][tokens]
        return x * torch.tensor(math.sqrt(self.cfg.d_model),
                                dtype=torch.float32).to(x.dtype)

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = rmsnorm(x, params["final_norm"], self.cfg.norm_eps)
        if self.cfg.tie_embeddings:
            return x @ params["embed"].T
        return x @ params["unembed"]

    # ------------------------------------------------------------------
    # serving: prefill + decode
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, seq_len: int) -> Cache:
        """Zeroed decode cache with room for ``seq_len`` positions: k / v
        [L, B, Hkv, seq_len, hd], or for an SSM the conv window
        [L, B, d_conv - 1, d_inner + 2N] and the fp32 SSD state
        [L, B, H, P, N]."""
        if seq_len > ROPE_TABLE_POSITIONS:
            raise ValueError(f"cache length {seq_len} exceeds the rope table "
                             f"({ROPE_TABLE_POSITIONS} positions)")
        cfg = self.cfg
        L, hd = cfg.num_layers, cfg.resolved_head_dim
        layers: Dict[str, torch.Tensor] = {}
        if cfg.arch_type == "ssm":
            one = ssm_lib.init_ssm_cache(batch, cfg.d_model, cfg.ssm,
                                         self.dtype, self.device)
            for k, v in one.items():
                layers[k] = v[None].repeat((L,) + (1,) * v.dim())
        else:
            shape = (L, batch, cfg.num_kv_heads, seq_len, hd)
            for k in ("k", "v"):
                layers[k] = torch.zeros(shape, dtype=self.dtype,
                                        device=self.device)
        return {
            "pos": torch.zeros((batch,), dtype=torch.int32,
                               device=self.device),
            "layers": layers,
        }

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                cache_len: int) -> Tuple[torch.Tensor, Cache]:
        """Process the prompt; return (last-position logits [B, 1, V], the
        filled cache: k / v padded to ``cache_len`` positions, or the SSM's
        conv window and state after the prompt)."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"])
        B, S, _ = x.shape
        y, layers = tfm.stack_prefill(params["blocks"], x, cfg,
                                      cfg.global_layer_flags())
        if "k" in layers:                  # the SSM cache has no positions
            pad = (0, 0, 0, cache_len - S)
            layers["k"] = F.pad(layers["k"], pad)
            layers["v"] = F.pad(layers["v"], pad)
        logits = self._logits(params, y[:, -1:])
        cache = {"pos": torch.full((B,), S, dtype=torch.int32,
                                   device=x.device),
                 "layers": layers}
        return logits, cache

    def decode_step(self, params: Params, tokens: torch.Tensor, cache: Cache
                    ) -> Tuple[torch.Tensor, Cache]:
        """One decode step. tokens: [B, 1] -> (logits [B, 1, V], new cache)."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        pos = cache["pos"]
        y, layers = tfm.stack_decode(params["blocks"], x, cache["layers"],
                                     pos, cfg, cfg.global_layer_flags())
        logits = self._logits(params, y)
        return logits, {"pos": pos + 1, "layers": layers}
