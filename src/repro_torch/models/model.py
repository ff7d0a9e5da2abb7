"""Model facade: embedding + stack + LM head, with ``init``, the training
entry points (``forward``, ``loss`` with the chunked cross-entropy), the
serving ones (``init_cache``, ``prefill``, ``decode_step``) and
``input_specs`` (meta-device stand-ins for the dry-run).

The counterpart of the JAX package's ``models/model.py`` for every family:
dense, moe, ssm, hybrid (hymba), vlm (internvl2: patch embeddings ahead of
the text, decoded as a dense stack) and audio (whisper: an encoder over
frame embeddings and a decoder with cross attention), and the int8 KV cache
of any attention family (``kv_quant``). Training is plain torch autograd
through plain torch ops, as the reference's is ``jax.value_and_grad``
through plain ``jnp``: no hand-written kernel is on that path.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.distributed.hints import carry, constrain
from repro_torch.distributed.sharding import (copy_to_model,
                                              gather_at_use,
                                              gather_from_model, local,
                                              max_over_model, model_block,
                                              place_block, placed_like,
                                              reduce_from_model, seq_block)
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.kvquant import quantize
from repro_torch.models.layers import (ROPE_TABLE_POSITIONS, Params,
                                       dense_init_, embed_init_, rmsnorm,
                                       sinusoidal_positions)

Cache = Dict[str, Any]


class Model:
    """Functional model wrapper for one ``ModelConfig``.

    Methods are functions of (params, inputs); the object holds the static
    configuration, the param dtype and the device. ``device`` defaults to
    the current CUDA device and raises when there is none. ``kv_quant``
    asks for an int8 KV cache; it is silently off for the families whose
    decode cache is not a decoder-only attention cache (ssm, audio), as in
    the JAX package. ``remat`` recomputes each layer (and each encoder
    layer) in the backward pass of ``loss``.
    """

    def __init__(self, config: ModelConfig,
                 param_dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = None, remat: bool = False,
                 kv_quant: bool = False):
        self.cfg = config
        self.dtype = param_dtype
        self.device = resolve_device(device)
        self.remat = remat
        self.kv_quant = kv_quant and config.arch_type not in ("ssm", "audio")

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

        def attention(n):
            return {
                "wq": dense_init_(empty(n, d, cfg.num_heads * hd), g),
                "wk": dense_init_(empty(n, d, cfg.num_kv_heads * hd), g),
                "wv": dense_init_(empty(n, d, cfg.num_kv_heads * hd), g),
                "wo": dense_init_(empty(n, cfg.num_heads * hd, d), g),
            }

        def gated_mlp(n):
            return {
                "w_gate": dense_init_(empty(n, d, cfg.d_ff), g),
                "w_up": dense_init_(empty(n, d, cfg.d_ff), g),
                "w_down": dense_init_(empty(n, cfg.d_ff, d), g),
            }

        params: Params = {
            "embed": embed_init_(empty(V, d), g),
            "final_norm": zeros(d),
        }
        if not cfg.tie_embeddings:
            params["unembed"] = embed_init_(empty(d, V), g)
        blocks: Params = {"ln1": zeros(L, d), "ln2": zeros(L, d)}
        if cfg.arch_type != "ssm":
            blocks["attn"] = attention(L)
        if cfg.has_ssm:
            blocks["mamba"] = ssm_lib.init_mamba(L, d, cfg.ssm, self.dtype,
                                                 self.device, g)
        if cfg.arch_type == "moe":
            blocks["moe"] = moe_lib.init_moe(L, d, cfg.d_ff, cfg.moe,
                                             self.dtype, self.device, g)
        elif cfg.arch_type != "ssm":
            blocks["mlp"] = gated_mlp(L)
        if cfg.is_encdec:
            Le = cfg.num_encoder_layers
            params["enc_blocks"] = {"ln1": zeros(Le, d), "ln2": zeros(Le, d),
                                    "attn": attention(Le),
                                    "mlp": gated_mlp(Le)}
            params["enc_norm"] = zeros(d)
            blocks["ln_cross"] = zeros(L, d)
            blocks["cross"] = attention(L)
        params["blocks"] = blocks
        if cfg.arch_type == "vlm":
            # projector stub: patch embeddings arrive pre-projected; a
            # learned scale keeps the projector path in the params
            params["patch_scale"] = torch.ones(d, dtype=self.dtype,
                                               device=self.device)
        return params

    def abstract_params(self) -> Params:
        """``init``'s tree on the meta device: shapes and dtypes, no
        storage (the reference's ``jax.eval_shape(model.init, rng)``)."""
        device, self.device = self.device, torch.device("meta")
        try:
            return self.init(torch.Generator())
        finally:
            self.device = device

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    # the layer stacks, which gather a layer at a time where it runs
    # (models/transformer.py)
    STACKS = ("blocks", "enc_blocks")

    def _gather_top(self, params: Params) -> Params:
        """``params`` with the leaves outside the layer stacks (embedding,
        unembedding, final norms, vlm's patch scale) gathered at use
        (``sharding.gather_at_use``): once a step, at its entry, since the
        embedding and the tied unembedding are one leaf. The stacks stay
        as they are. Plain tensors pass through."""
        return {k: (v if k in self.STACKS else gather_at_use(v))
                for k, v in params.items()}

    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        """The scaled embedding of ``tokens``. On this rank's "model" block
        of the vocabulary (``sharding.gather_at_use``), a vocab-parallel
        lookup: tokens outside the block read zeros, and the ranks' rows
        are summed (``reduce_from_model``)."""
        emb = params["embed"]
        ax, off = model_block(emb, 0, self.cfg.padded_vocab)
        tok = tokens.long()
        if ax is not None:
            tok = tok - off
            inside = (tok >= 0) & (tok < emb.shape[0])
            tok = torch.where(inside, tok, torch.zeros_like(tok))
        # F.embedding, not indexing: its backward adds repeated tokens' rows
        # in a fixed order (indexing's accumulate is atomic on the CPU)
        x = F.embedding(tok, emb)
        if ax is not None:
            x = reduce_from_model(x * inside[..., None].to(x.dtype), ax)
        return x * torch.tensor(math.sqrt(self.cfg.d_model),
                                dtype=torch.float32).to(x.dtype)

    def _unembed(self, params: Params) -> torch.Tensor:
        return (params["embed"].T if self.cfg.tie_embeddings
                else params["unembed"])

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """Logits of the final hidden states: on this rank's "model" block
        of the vocabulary (tied ``embed`` on ``("model", None)``, or
        ``unembed`` on ``(fsdp, "model")``), the rank's slice of them,
        behind ``copy_to_model``; whole otherwise."""
        x = rmsnorm(x, params["final_norm"], self.cfg.norm_eps)
        w = self._unembed(params)
        ax, _ = model_block(w, 1, self.cfg.padded_vocab)
        if ax is not None:
            x = copy_to_model(x, ax)
        return x @ w

    def _full_logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """``_logits`` over the whole vocabulary: the ranks' slices
        gathered over "model" (a server's greedy token reads them all)."""
        logits = self._logits(params, x)
        ax, _ = model_block(self._unembed(params), 1, self.cfg.padded_vocab)
        return logits if ax is None else gather_from_model(logits, ax)

    def _encode(self, params: Params, frames: torch.Tensor) -> torch.Tensor:
        """The whisper encoder over stubbed frame embeddings [B, T, d]."""
        pos = sinusoidal_positions(frames.shape[1], self.cfg.d_model,
                                   frames.device)
        x = frames + pos[None].to(frames.dtype)
        x = tfm.encoder_stack(params["enc_blocks"], x, self.cfg,
                              remat=self.remat)
        return rmsnorm(x, params["enc_norm"], self.cfg.norm_eps)

    def _decoder_input(self, params: Params,
                       batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The decoder stack's input embedding for this family: the patch
        prefix ahead of the text for vlm, absolute sinusoidal positions
        for audio."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"])
        if cfg.arch_type == "vlm":
            patches = batch["patch_embeds"].to(x.dtype) * params["patch_scale"]
            x = torch.cat([patches, x], dim=1)
        if cfg.is_encdec:
            pos = sinusoidal_positions(x.shape[1], cfg.d_model, x.device)
            x = x + pos[None].to(x.dtype)
        return constrain(x, "btd")

    # ------------------------------------------------------------------
    # training forward / loss
    # ------------------------------------------------------------------
    def forward(self, params: Params, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward. Returns (logits [B, S, V], moe_aux_loss)."""
        params = self._gather_top(params)
        y, aux = self._hidden(params, batch)
        return self._full_logits(params, y), aux

    # sequence-chunk size for the CE loss: never materialize [B, S, V]
    LOSS_CHUNK = 512

    def _hidden(self, params: Params, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward up to the final hidden states."""
        cfg = self.cfg
        x = self._decoder_input(params, batch)
        if cfg.is_encdec:
            mem = self._encode(params, batch["frames"])
            y = tfm.encdec_decoder_full(params["blocks"], x, mem, cfg,
                                        remat=self.remat)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        else:
            y, aux = tfm.stack_full(params["blocks"], x, cfg,
                                    cfg.global_layer_flags(),
                                    remat=self.remat)
        return y, aux

    def _chunked_ce(self, params: Params, y: torch.Tensor,
                    labels: torch.Tensor, mask: Optional[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Next-token CE over sequence chunks of ``LOSS_CHUNK``: the
        logits live one [B, c, V] fp32 slab at a time, recomputed in the
        backward pass (a 262k vocabulary at B·c = 2048 is 2.15 GB a
        slab). ``logsumexp`` minus the gold logit, masked, summed; returns
        (that sum, the mask's count).

        On this rank's "model" block of the vocabulary, vocab-parallel, in
        fp32: the max over the ranks (all-reduced, outside autograd), the
        sum of the exps all-reduced, and the gold logit taken on the rank
        that holds it and all-reduced (``reduce_from_model``: identity
        backward, so each rank's gradient is its block's). Every rank
        issues these collectives in the same order, in the forward and in
        the recompute."""
        B, S, _ = y.shape
        ax, off = model_block(self._unembed(params), 1, self.cfg.padded_vocab)
        c = min(self.LOSS_CHUNK, S)
        if S % c:
            c = S  # irregular smoke shapes: single chunk
        if mask is None:
            mask = torch.ones((B, S), dtype=torch.float32, device=y.device)

        def body(ych, lch, mch):
            logits = self._logits(params, constrain(ych, "btd")).float()
            if ax is None:
                logz = torch.logsumexp(logits, dim=-1)
                gold = torch.gather(logits, -1,
                                    lch[..., None].long())[..., 0]
            else:
                m = max_over_model(logits.amax(dim=-1, keepdim=True), ax)
                sumexp = reduce_from_model(
                    torch.exp(logits - m).sum(dim=-1), ax)
                logz = torch.log(sumexp) + m[..., 0]
                lab = lch.long() - off
                inside = (lab >= 0) & (lab < logits.shape[-1])
                lab = torch.where(inside, lab, torch.zeros_like(lab))
                gold = torch.gather(logits, -1, lab[..., None])[..., 0]
                gold = reduce_from_model(gold * inside.float(), ax)
            nll = (logz - gold) * mch
            return torch.sum(nll), torch.sum(mch)

        tot = torch.zeros((), dtype=torch.float32, device=y.device)
        cnt = torch.zeros((), dtype=torch.float32, device=y.device)
        for i in range(0, S, c):
            args = (y[:, i:i + c], labels[:, i:i + c], mask[:, i:i + c])
            if torch.is_grad_enabled():
                t, n = checkpoint(carry(body), *args, use_reentrant=False)
            else:
                t, n = body(*args)
            tot, cnt = tot + t, cnt + n
        return tot, cnt

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
        """Mean next-token CE (fp32 scalar); image-patch positions carry no
        target (vlm); MoE adds ``aux_loss_weight`` times the aux loss."""
        tot, cnt, aux = self.loss_terms(params, batch)
        ce = tot / torch.clamp(cnt, min=1.0)
        if self.cfg.has_moe:
            ce = ce + self.cfg.moe.aux_loss_weight * aux
        return ce

    def loss_terms(self, params: Params, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The parts of ``loss``: (the masked CE summed over the batch's
        target positions, their count, the MoE aux loss summed over the
        layers (0 without MoE)), fp32 scalars. A rank that holds a block
        of the batch divides its sum by the global count
        (``training/train_loop.py``)."""
        cfg = self.cfg
        params = self._gather_top(params)
        y, aux = self._hidden(params, batch)
        labels = batch["labels"]
        mask = batch.get("loss_mask")
        if cfg.arch_type == "vlm":
            P = cfg.num_patch_tokens
            B = labels.shape[0]
            labels = torch.cat([labels.new_zeros((B, P)), labels], dim=1)
            m = torch.cat([torch.zeros((B, P), dtype=torch.float32,
                                       device=labels.device),
                           torch.ones(batch["labels"].shape,
                                      dtype=torch.float32,
                                      device=labels.device)], dim=1)
            mask = m if mask is None else mask * m
        tot, cnt = self._chunked_ce(params, y, labels, mask)
        return tot, cnt, aux

    # ------------------------------------------------------------------
    # serving: prefill + decode
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, seq_len: int,
                   enc_len: Optional[int] = None) -> Cache:
        """Zeroed decode cache with room for ``seq_len`` positions: k / v
        [L, B, Hkv, seq_len, hd] (int8 with ``k_scale`` / ``v_scale``
        [.., 1] under ``kv_quant``), the SSM's conv window
        [L, B, d_conv - 1, d_inner + 2N] and fp32 state [L, B, H, P, N]
        (ssm, hybrid), and whisper's cross k / v of ``enc_len`` positions
        (default ``encoder_seq_len``)."""
        if seq_len > ROPE_TABLE_POSITIONS:
            raise ValueError(f"cache length {seq_len} exceeds the rope table "
                             f"({ROPE_TABLE_POSITIONS} positions)")
        return self._zero_cache(batch, seq_len, enc_len, self.device)

    def _zero_cache(self, batch: int, seq_len: int, enc_len: Optional[int],
                    device: torch.device) -> Cache:
        cfg = self.cfg
        L, hd = cfg.num_layers, cfg.resolved_head_dim

        def zeros(shape, dtype=self.dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        layers: Dict[str, torch.Tensor] = {}
        if cfg.arch_type != "ssm":
            shape = (L, batch, cfg.num_kv_heads, seq_len, hd)
            kv_dtype = torch.int8 if self.kv_quant else self.dtype
            layers["k"] = zeros(shape, kv_dtype)
            layers["v"] = zeros(shape, kv_dtype)
            if self.kv_quant:
                layers["k_scale"] = zeros(shape[:-1] + (1,))
                layers["v_scale"] = zeros(shape[:-1] + (1,))
        if cfg.has_ssm:
            one = ssm_lib.init_ssm_cache(batch, cfg.d_model, cfg.ssm,
                                         self.dtype, device)
            for k, v in one.items():
                layers[k] = v[None].repeat((L,) + (1,) * v.dim())
        if cfg.is_encdec:
            T = enc_len or cfg.encoder_seq_len
            shape = (L, batch, cfg.num_kv_heads, T, hd)
            layers["cross_k"] = zeros(shape)
            layers["cross_v"] = zeros(shape)
        return {"pos": zeros((batch,), torch.int32), "layers": layers}

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                cache_len: int, cache_shardings: Any = None
                ) -> Tuple[torch.Tensor, Cache]:
        """Process the prompt (``tokens``, and ``patch_embeds`` [B, P, d]
        for vlm or ``frames`` [B, T, d] for audio); return (last-position
        logits [B, 1, V], the filled cache: k / v padded to ``cache_len``
        positions and quantized under ``kv_quant``, the SSM's conv window
        and state after the prompt, whisper's cross k / v).

        ``cache_shardings`` (``sharding.cache_shardings`` on a
        ``DeviceMesh``, for a batch of which ``batch`` is this rank's
        block): the attention is data-parallel compute, as in the
        reference, and the cache comes back as DTensors placed by them,
        each rank keeping its sequence block of the k / v it wrote
        (``sharding.place_block``), the decode's sequence-sharded cache."""
        cfg = self.cfg
        params = self._gather_top(params)
        x = self._decoder_input(params, batch)
        B, S, _ = x.shape
        if cfg.is_encdec:
            mem = self._encode(params, batch["frames"])
            y, layers = tfm.encdec_decoder_full(params["blocks"], x, mem, cfg,
                                                with_cache=True)
        else:
            y, layers = tfm.stack_prefill(params["blocks"], x, cfg,
                                          cfg.global_layer_flags())
        if "k" in layers:                  # the SSM cache has no positions
            pad = (0, 0, 0, cache_len - S)
            layers["k"] = F.pad(layers["k"], pad)
            layers["v"] = F.pad(layers["v"], pad)
            if self.kv_quant:
                layers["k"], layers["k_scale"] = quantize(
                    layers["k"], scale_dtype=self.dtype)
                layers["v"], layers["v_scale"] = quantize(
                    layers["v"], scale_dtype=self.dtype)
        logits = self._full_logits(params, y[:, -1:])
        cache = {"pos": torch.full((B,), S, dtype=torch.int32,
                                   device=x.device),
                 "layers": layers}
        if cache_shardings is not None:
            cache = {"pos": place_block(cache["pos"], cache_shardings["pos"],
                                        0),
                     "layers": {k: place_block(v, cache_shardings["layers"][k],
                                               1)
                                for k, v in layers.items()}}
        return logits, cache

    def decode_step(self, params: Params, tokens: torch.Tensor, cache: Cache
                    ) -> Tuple[torch.Tensor, Cache]:
        """One decode step. tokens: [B, 1] -> (logits [B, 1, V], new cache).

        A cache of DTensors (``prefill(cache_shardings=)``, or placed by
        ``sharding.cache_shardings``) is read as this rank's blocks:
        ``tokens`` is the rank's block of the batch, a k / v cache sharded
        on its sequence attends over its block with the softmax combined
        across the ranks (``sharding.seq_block``), and the new cache comes
        back placed as the old one. A plain cache is today's path."""
        cfg = self.cfg
        seq = seq_block(cache["layers"]["k"], 3) \
            if "k" in cache["layers"] else None
        cross_seq = seq_block(cache["layers"]["cross_k"], 3) \
            if "cross_k" in cache["layers"] else None
        pos = local(cache["pos"])
        cache_layers = {k: local(v) for k, v in cache["layers"].items()}
        params = self._gather_top(params)
        x = self._embed(params, tokens)
        if cfg.is_encdec:
            # each row's new token at its absolute sinusoidal position (an
            # index past the table clamps to its end, as a JAX gather does)
            S = int(cache_layers["k"].shape[3]) if seq is None else seq.total
            table = sinusoidal_positions(S, cfg.d_model, x.device)
            posv = torch.broadcast_to(pos, (tokens.shape[0],)).long()
            x = x + table[posv.clamp(0, S - 1)][:, None].to(x.dtype)
            y, layers = tfm.encdec_decoder_decode(params["blocks"], x,
                                                  cache_layers, pos, cfg,
                                                  seq=seq,
                                                  cross_seq=cross_seq)
        else:
            y, layers = tfm.stack_decode(params["blocks"], x,
                                         cache_layers, pos, cfg,
                                         cfg.global_layer_flags(), seq=seq)
        logits = self._full_logits(params, y)
        return logits, {
            "pos": placed_like(pos + 1, cache["pos"]),
            "layers": {k: placed_like(v, cache["layers"][k])
                       for k, v in layers.items()}}

    # ------------------------------------------------------------------
    # dry-run input specs (meta-device stand-ins; no allocation)
    # ------------------------------------------------------------------
    def input_specs(self, shape: InputShape) -> Dict[str, Any]:
        """Abstract inputs for the step selected by ``shape.kind``: tensors
        on the meta device with the reference's shapes and dtypes (its
        ``ShapeDtypeStruct`` stand-ins)."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len

        def meta(*dims, dtype=self.dtype):
            return torch.empty(dims, dtype=dtype, device="meta")

        def tok(b, s):
            return meta(b, s, dtype=torch.int32)

        if shape.kind in ("train", "prefill"):
            specs: Dict[str, Any] = {}
            s_text = S - cfg.num_patch_tokens if cfg.arch_type == "vlm" else S
            specs["tokens"] = tok(B, s_text)
            if shape.kind == "train":
                specs["labels"] = tok(B, s_text)
            if cfg.arch_type == "vlm":
                specs["patch_embeds"] = meta(B, cfg.num_patch_tokens,
                                             cfg.d_model)
            if cfg.is_encdec:
                specs["frames"] = meta(B, cfg.encoder_seq_len, cfg.d_model)
            return specs
        # decode: one token against a cache holding ``seq_len`` positions
        cache = self._zero_cache(B, S, cfg.encoder_seq_len or None,
                                 torch.device("meta"))
        return {"tokens": tok(B, 1), "cache": cache}
