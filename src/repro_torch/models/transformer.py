"""The decoder stacks of every family: prefill and single-token decode over
stacked per-layer params (a loop over the leading layer axis), and the
whisper encoder and decoder.

An MoE layer is GQA attention followed by the MoE FFN (``models/moe.py``)
in place of the gated MLP; an SSM layer is a Mamba-2 block
(``models/ssm.py``) on the pre-norm input and no FFN, and its cache is the
conv window and the SSD state (``conv`` / ``h``) instead of k / v. A hybrid
(hymba) layer runs attention and an SSM head in parallel on the pre-norm
input and fuses them as ``0.5 * (a + s)``, then the gated MLP; its cache
holds k / v and conv / h. An int8 KV cache (``k_scale`` / ``v_scale`` in
the cache) is quantized on write and dequantized on read. Whisper (audio)
has no rope: its positions are absolute sinusoids added to the input
(``models/model.py``), its encoder is bidirectional and its decoder layers
add cross attention over the encoder memory, whose K/V sit in the decode
cache (``cross_k`` / ``cross_v``).

The JAX package scans over layers; here the loop is plain Python and the
stacked [L, ...] layout of the params and of the cache is kept. The
training stack (``stack_full``, ``block_full``) pins its activations with
``distributed.hints.constrain`` where the reference does (a no-op outside
an ``activation_sharding`` context). ``remat=True`` runs each layer body
under ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of the
scan body): the backward recomputes the layer from its input.

Placed params (DTensors, ``launch/mesh.production_state``) are gathered a
layer at a time where the layer runs (``sharding.gather_at_use``, ZeRO-3):
inside the layer's remat body, so the recompute gathers again and no
gathered layer outlives its use. Plain tensors pass through as they are.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.hints import carry, constrain
from repro_torch.distributed.sharding import SeqBlock, gather_at_use
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import Params, mlp, rmsnorm

Cache = Dict[str, Any]


def _unstack(stacked: Params) -> list:
    """Every layer's params as views into the stacked tree, from one
    ``unbind`` a leaf. Under autograd the stacked gradient is then one
    stack of the layers' gradients, as the reference's scan writes each
    layer's into its slot; a separate ``v[l]`` a layer would zero-fill
    the whole [L, ...] gradient and add it once a layer (O(L²) bytes).
    A DTensor leaf unbinds its local block, each layer wrapped back as a
    DTensor of the leaf's placements one dimension down (the rules never
    shard the layer axis)."""
    n = None
    flat = {}
    for k, v in stacked.items():
        flat[k] = _unstack(v) if isinstance(v, dict) else _unbind(v)
        n = len(flat[k])
    return [{k: v[l] for k, v in flat.items()} for l in range(n)]


def _unbind(v: torch.Tensor) -> Sequence[torch.Tensor]:
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(v, DTensor):
        return v.unbind(0)
    if any(isinstance(p, Shard) and p.dim == 0 for p in v.placements):
        raise ValueError(f"a stacked leaf sharded on its layer axis: "
                         f"{v.placements}")
    down = [Shard(p.dim - 1) if isinstance(p, Shard) else p
            for p in v.placements]
    return [DTensor.from_local(t, v.device_mesh, down, run_check=False)
            for t in v.to_local().unbind(0)]


def _ffn(p: Params, h2: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The layer's FFN on the post-norm input [B, S, d]: the MoE FFN over
    the B·S tokens as one group, or the gated MLP."""
    if cfg.has_moe and cfg.arch_type != "hybrid":
        B, S, d = h2.shape
        y, _aux = moe_lib.moe_ffn(p["moe"], h2.reshape(B * S, d), cfg.moe,
                                  d_ff=cfg.d_ff)
        return y.reshape(B, S, d)
    return mlp(p["mlp"], h2, cfg.d_ff)


def _attn_kw(cfg: ModelConfig, is_global: bool) -> Dict[str, Any]:
    return dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                is_global=is_global, window=cfg.window_size,
                use_rope=cfg.arch_type != "audio")


def _maybe_remat(fn: Callable, remat: bool) -> Callable:
    """``fn`` itself, or ``fn`` recomputed in the backward pass when
    ``remat`` and grad are on (non-reentrant checkpoint), under the
    forward's activation hints (``hints.carry``)."""
    if not remat:
        return fn

    def body(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(carry(fn), *args, use_reentrant=False)

    return body


# ---------------------------------------------------------------------------
# full-sequence (training) forward
# ---------------------------------------------------------------------------

def _mixer_full(p: Params, h: torch.Tensor, cfg: ModelConfig,
                is_global: bool) -> torch.Tensor:
    """Token mixer (attention and / or SSM) on the normed input, full
    sequence."""
    if cfg.arch_type == "ssm":
        return ssm_lib.ssd_chunked(p["mamba"], h, cfg.ssm)
    a = attn.attention_full(p["attn"], h, causal=True,
                            **_attn_kw(cfg, is_global))
    if cfg.arch_type == "hybrid":
        s = ssm_lib.ssd_chunked(p["mamba"], h, cfg.ssm)
        # hymba fuses the parallel attention and SSM heads by mean
        return 0.5 * (a + s)
    return a


def block_full(p: Params, x: torch.Tensor, cfg: ModelConfig,
               is_global: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One full-sequence layer: returns (y, moe_aux_loss fp32 scalar)."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    x = x + _mixer_full(p, h, cfg, is_global)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.arch_type == "ssm":
        return x, aux
    h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
    if cfg.has_moe and cfg.arch_type != "hybrid":
        B, S, d = h2.shape
        y, aux = moe_lib.moe_ffn(p["moe"], h2.reshape(B * S, d), cfg.moe,
                                 d_ff=cfg.d_ff)
        y = y.reshape(B, S, d)
    else:
        y = mlp(p["mlp"], h2, cfg.d_ff)
    return x + y, aux


def stack_full(stacked: Params, x: torch.Tensor, cfg: ModelConfig,
               flags: Sequence[bool], remat: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run all layers over the full sequence. flags: one is_global bool a
    layer. Returns (y, the layers' summed MoE aux loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = _unstack(stacked)
    for l, is_global in enumerate(flags):
        def body(x, p=layers[l], is_global=is_global):
            y, a = block_full(gather_at_use(p), constrain(x, "btd"), cfg,
                              is_global)
            return constrain(y, "btd"), a

        x, a = _maybe_remat(body, remat)(x)
        aux = aux + a
    return x, aux


def stack_prefill(stacked: Params, x: torch.Tensor, cfg: ModelConfig,
                  flags: Sequence[bool]) -> Tuple[torch.Tensor, Cache]:
    """Full forward emitting the per-layer decode cache: [L, B, Hkv, S, hd]
    k / v, and / or the SSM's conv window and state."""
    out: Dict[str, list] = {}
    layers = _unstack(stacked)
    for l, is_global in enumerate(flags):
        p = gather_at_use(layers[l])
        h = rmsnorm(x, p["ln1"], cfg.norm_eps)
        if cfg.arch_type == "ssm":
            y, st = ssm_lib.ssd_chunked(p["mamba"], h, cfg.ssm,
                                        return_state=True)
            for k in ("conv", "h"):
                out.setdefault(k, []).append(st[k])
            x = x + y
            continue
        a, k, v = attn.attention_full(p["attn"], h, causal=True,
                                      return_kv=True,
                                      **_attn_kw(cfg, is_global))
        out.setdefault("k", []).append(k.transpose(1, 2))   # [B,Hkv,S,hd]
        out.setdefault("v", []).append(v.transpose(1, 2))
        if cfg.arch_type == "hybrid":
            y, st = ssm_lib.ssd_chunked(p["mamba"], h, cfg.ssm,
                                        return_state=True)
            for k in ("conv", "h"):
                out.setdefault(k, []).append(st[k])
            # hymba fuses the parallel attention and SSM heads by mean
            a = 0.5 * (a + y)
        x = x + a
        h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = x + _ffn(p, h2, cfg)
    return x, {k: torch.stack(v) for k, v in out.items()}


def stack_decode(stacked: Params, x: torch.Tensor, cache: Cache,
                 pos: torch.Tensor, cfg: ModelConfig,
                 flags: Sequence[bool], seq: Optional[SeqBlock] = None
                 ) -> Tuple[torch.Tensor, Cache]:
    """One-token decode through all layers; returns the new layer cache
    (new tensors, in the input cache's dtypes — the input cache is left as
    it was). ``seq``: the k / v cache is this rank's block of a
    sequence-sharded cache (``attention.attention_decode``)."""
    out: Dict[str, list] = {k: [] for k in cache}
    layers = _unstack(stacked)
    for l, is_global in enumerate(flags):
        p = gather_at_use(layers[l])
        c = {k: v[l] for k, v in cache.items()}
        h = rmsnorm(x, p["ln1"], cfg.norm_eps)
        new: Dict[str, torch.Tensor] = {}
        if cfg.arch_type == "ssm":
            y, st = ssm_lib.ssd_decode_step(
                p["mamba"], h, {"conv": c["conv"], "h": c["h"]}, cfg.ssm)
            new.update(st)
            x = x + y
        else:
            kw = _attn_kw(cfg, is_global)
            if "k_scale" in c:         # int8 KV cache
                a, nk, nv, nks, nvs = attn.attention_decode(
                    p["attn"], h, c["k"], c["v"], pos,
                    k_scale=c["k_scale"], v_scale=c["v_scale"], seq=seq,
                    **kw)
                new["k_scale"], new["v_scale"] = nks, nvs
            else:
                a, nk, nv = attn.attention_decode(
                    p["attn"], h, c["k"], c["v"], pos, seq=seq, **kw)
            new["k"], new["v"] = nk, nv
            if cfg.arch_type == "hybrid":
                y, st = ssm_lib.ssd_decode_step(
                    p["mamba"], h, {"conv": c["conv"], "h": c["h"]},
                    cfg.ssm)
                new.update(st)
                a = 0.5 * (a + y)
            x = x + a
            h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
            x = x + _ffn(p, h2, cfg)
        for k in out:
            out[k].append(new[k].to(cache[k].dtype))
    return x, {k: torch.stack(v) for k, v in out.items()}


# ---------------------------------------------------------------------------
# whisper: bidirectional encoder; decoder with self + cross attention
# ---------------------------------------------------------------------------

def encoder_stack(stacked: Params, x: torch.Tensor, cfg: ModelConfig,
                  remat: bool = False) -> torch.Tensor:
    """The whisper encoder over frame embeddings [B, T, d] (no cache)."""
    def body(x, p):
        p = gather_at_use(p)
        h = rmsnorm(x, p["ln1"], cfg.norm_eps)
        x = x + attn.attention_full(
            p["attn"], h, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
            rope_theta=cfg.rope_theta, causal=False, use_rope=False)
        h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
        return x + mlp(p["mlp"], h2, cfg.d_ff)

    body = _maybe_remat(body, remat)
    for p in _unstack(stacked):
        x = body(x, p)
    return x


def encdec_decoder_full(stacked: Params, x: torch.Tensor, mem: torch.Tensor,
                        cfg: ModelConfig, with_cache: bool = False,
                        remat: bool = False):
    """Whisper decoder full-sequence forward; with ``with_cache`` also the
    decode cache: self k / v of the prompt and cross k / v of the encoder
    memory, [L, B, Hkv, S or T, hd]. ``remat`` applies without the cache
    only, as in the reference."""
    hd = cfg.resolved_head_dim
    out: Dict[str, list] = {}

    def body(x, mem, p):
        p = gather_at_use(p)
        h = rmsnorm(x, p["ln1"], cfg.norm_eps)
        a = attn.attention_full(
            p["attn"], h, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=hd,
            rope_theta=cfg.rope_theta, causal=True, use_rope=False,
            return_kv=with_cache)
        if with_cache:
            a, k, v = a
            out.setdefault("k", []).append(k.transpose(1, 2))
            out.setdefault("v", []).append(v.transpose(1, 2))
        x = x + a
        hc = rmsnorm(x, p["ln_cross"], cfg.norm_eps)
        km, vm = attn.project_memory_kv(p["cross"], mem,
                                        num_kv_heads=cfg.num_kv_heads,
                                        head_dim=hd)
        if with_cache:
            out.setdefault("cross_k", []).append(km)
            out.setdefault("cross_v", []).append(vm)
        x = x + attn.attention_cross(p["cross"], hc, km, vm,
                                     num_heads=cfg.num_heads,
                                     num_kv_heads=cfg.num_kv_heads,
                                     head_dim=hd)
        h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
        return x + mlp(p["mlp"], h2, cfg.d_ff)

    body = _maybe_remat(body, remat and not with_cache)
    for p in _unstack(stacked):
        x = body(x, mem, p)
    if with_cache:
        return x, {k: torch.stack(v) for k, v in out.items()}
    return x


def encdec_decoder_decode(stacked: Params, x: torch.Tensor, cache: Cache,
                          pos: torch.Tensor, cfg: ModelConfig,
                          seq: Optional[SeqBlock] = None,
                          cross_seq: Optional[SeqBlock] = None
                          ) -> Tuple[torch.Tensor, Cache]:
    """One-token whisper decode; the cache holds self k / v (updated) and
    cross_k / cross_v (fixed, passed through). ``seq`` / ``cross_seq``:
    the self / cross cache is this rank's block of a sequence-sharded
    one."""
    hd = cfg.resolved_head_dim
    ks, vs = [], []
    layers = _unstack(stacked)
    for l in range(cfg.num_layers):
        p = gather_at_use(layers[l])
        h = rmsnorm(x, p["ln1"], cfg.norm_eps)
        a, nk, nv = attn.attention_decode(
            p["attn"], h, cache["k"][l], cache["v"][l], pos,
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=hd, rope_theta=cfg.rope_theta, use_rope=False,
            seq=seq)
        ks.append(nk)
        vs.append(nv)
        x = x + a
        hc = rmsnorm(x, p["ln_cross"], cfg.norm_eps)
        x = x + attn.attention_cross(p["cross"], hc, cache["cross_k"][l],
                                     cache["cross_v"][l],
                                     num_heads=cfg.num_heads,
                                     num_kv_heads=cfg.num_kv_heads,
                                     head_dim=hd, seq=cross_seq)
        h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = x + mlp(p["mlp"], h2, cfg.d_ff)
    return x, {"k": torch.stack(ks), "v": torch.stack(vs),
               "cross_k": cache["cross_k"], "cross_v": cache["cross_v"]}
