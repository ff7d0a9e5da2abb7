"""Model facade for dense decoders: embedding + stack + LM head, with
``init``, ``init_cache``, ``prefill`` and ``decode_step``.

The counterpart of the JAX package's ``models/model.py`` for arch_type
"dense". The other families (moe, ssm, hybrid, vlm, audio) and the training
entry points are not ported yet (ROADMAP queue 1, items 8, 12 and 13).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (ROPE_TABLE_POSITIONS, Params,
                                       dense_init_, embed_init_, rmsnorm)

Cache = Dict[str, Any]


class Model:
    """Functional model wrapper for one dense ``ModelConfig``.

    Methods are functions of (params, inputs); the object holds the static
    configuration, the param dtype and the device. ``device`` defaults to
    the current CUDA device and raises when there is none.
    """

    def __init__(self, config: ModelConfig,
                 param_dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = None):
        if config.arch_type != "dense":
            raise NotImplementedError(
                f"arch_type {config.arch_type!r} is not ported yet: the "
                f"port serves dense decoders (ROADMAP queue 1, items 8 and "
                f"12)")
        self.cfg = config
        self.dtype = param_dtype
        self.device = resolve_device(device)

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator) -> Params:
        """Random params at the config's widths, made on the model's device
        from ``generator`` (a ``torch.Generator`` on that device)."""
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
        params["blocks"] = {
            "ln1": zeros(L, d),
            "ln2": zeros(L, d),
            "attn": {
                "wq": dense_init_(empty(L, d, cfg.num_heads * hd), g),
                "wk": dense_init_(empty(L, d, cfg.num_kv_heads * hd), g),
                "wv": dense_init_(empty(L, d, cfg.num_kv_heads * hd), g),
                "wo": dense_init_(empty(L, cfg.num_heads * hd, d), g),
            },
            "mlp": {
                "w_gate": dense_init_(empty(L, d, cfg.d_ff), g),
                "w_up": dense_init_(empty(L, d, cfg.d_ff), g),
                "w_down": dense_init_(empty(L, cfg.d_ff, d), g),
            },
        }
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
        """Zeroed decode cache with room for ``seq_len`` positions."""
        if seq_len > ROPE_TABLE_POSITIONS:
            raise ValueError(f"cache length {seq_len} exceeds the rope table "
                             f"({ROPE_TABLE_POSITIONS} positions)")
        cfg = self.cfg
        L, hd = cfg.num_layers, cfg.resolved_head_dim
        shape = (L, batch, cfg.num_kv_heads, seq_len, hd)
        return {
            "pos": torch.zeros((batch,), dtype=torch.int32,
                               device=self.device),
            "layers": {
                "k": torch.zeros(shape, dtype=self.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=self.dtype, device=self.device),
            },
        }

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                cache_len: int) -> Tuple[torch.Tensor, Cache]:
        """Process the prompt; return (last-position logits [B, 1, V], the
        filled cache padded to ``cache_len`` positions)."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"])
        B, S, _ = x.shape
        y, layers = tfm.stack_prefill(params["blocks"], x, cfg,
                                      cfg.global_layer_flags())
        pad = (0, 0, 0, cache_len - S)
        layers = {k: F.pad(v, pad) for k, v in layers.items()}
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
