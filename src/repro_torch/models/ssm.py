"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060) block.

The counterpart of the JAX package's ``models/ssm.py``. Two paths:

* ``ssd_chunked`` — prefill: the quadratic intra-chunk part as matmuls,
  the inter-chunk part as a linear recurrence over chunk states (a Python
  loop over chunks where the JAX package runs ``lax.scan``);
* ``ssd_decode_step`` — one token: h = a·h + dt·B⊗x, y = C·h + D·x.

Shapes: d_inner = expand·d_model, H heads of size P = head_dim, state size
N = d_state, one B/C group. Params are stacked on a leading layer axis;
the functions take one layer's slice.

Precision follows the JAX package: the scalar decay chain stays fp32, and
its einsums take compute-dtype inputs with fp32 results
(``preferred_element_type=float32``). A bf16 ``torch.einsum`` would round
its result to bf16, so the inputs are rounded to the compute dtype first
and then widened to fp32 before each einsum. ``jax.nn.softplus`` is
``logaddexp(x, 0)``; ``F.softplus`` returns x above a threshold instead,
so ``softplus`` below is ``torch.logaddexp(x, 0)``.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.models.layers import Params, dense_init_, rmsnorm


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def init_mamba(num_layers: int, d_model: int, cfg: SSMConfig,
               dtype: torch.dtype, device: torch.device,
               generator: torch.Generator) -> Params:
    """Stacked Mamba-2 params of ``num_layers`` layers, drawn from
    ``generator``. ``dt_bias``, ``A_log`` and ``D`` stay fp32."""
    L = num_layers
    d_inner = cfg.expand * d_model
    H = cfg.num_heads(d_model)
    N = cfg.d_state
    conv_dim = d_inner + 2 * N
    g = generator
    f32 = dict(dtype=torch.float32, device=device)
    # dt bias initialised so softplus(dt_bias) spans [1e-3, 1e-1]
    u = torch.rand((L, H), generator=g, **f32)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(0.001))
                        + math.log(0.001))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))
    conv_w = torch.randn((L, cfg.d_conv, conv_dim), generator=g, **f32) * 0.1
    return {
        "in_proj": dense_init_(torch.empty(
            (L, d_model, 2 * d_inner + 2 * N + H), dtype=dtype,
            device=device), g),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((L, conv_dim), dtype=dtype, device=device),
        "dt_bias": dt_bias,
        "A_log": torch.log(torch.arange(1, H + 1, **f32)).expand(L, H)
        .contiguous(),
        "D": torch.ones((L, H), **f32),
        "norm": torch.zeros((L, d_inner), dtype=dtype, device=device),
        "out_proj": dense_init_(torch.empty((L, d_inner, d_model),
                                            dtype=dtype, device=device), g),
    }


def _split_zxbcdt(zxbcdt: torch.Tensor, d_inner: int, N: int):
    """The in_proj packing layout: [z (d_inner) | xBC (d_inner + 2N) |
    dt (H)]. Both the full-sequence path and ``decode_core`` (which the
    JIT's SSM templates feed from a declared GEMM) split through here."""
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * N,
                                int(zxbcdt.shape[-1]) - 2 * d_inner - 2 * N],
                       dim=-1)


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time. xBC: [B, S, Cdim]; w: [K, Cdim]."""
    K = int(w.shape[0])
    S = int(xBC.shape[1])
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = torch.zeros(xBC.shape, dtype=torch.float32, device=xBC.device)
    for i in range(K):       # K is tiny (4)
        out = out + pad[:, i:i + S].float() * w[i].float()
    return F.silu(out + b.float())


def ssd_chunked(params: Params, u: torch.Tensor, cfg: SSMConfig,
                return_state: bool = False):
    """Full-sequence SSD. u: [B, S, d_model] -> [B, S, d_model].

    With ``return_state=True`` also returns the recurrent cache
    {"conv", "h"} after the last position (the serving prefill's). The
    conv window is the last ``d_conv - 1`` pre-conv inputs, so the prompt
    must be at least that long."""
    Bsz, S0, d_model = u.shape
    assert S0 >= cfg.d_conv - 1, (S0, cfg.d_conv)
    Q = cfg.chunk_size
    # right-pad the sequence to a chunk multiple; padded steps get
    # dt = softplus(-30 + bias) ~ 0, so they leave the state as it was
    S = ((S0 + Q - 1) // Q) * Q
    if S != S0:
        u = F.pad(u, (0, 0, 0, S - S0))
    nc = S // Q
    d_inner = cfg.expand * d_model
    H = cfg.num_heads(d_model)
    N = cfg.d_state
    P = cfg.head_dim
    z, xBC, dt = _split_zxbcdt(u @ params["in_proj"], d_inner, N)
    if S != S0:
        dt = dt.clone()
        dt[:, S0:, :] = -30.0          # freeze the state on padded steps

    conv_tail = xBC[:, S0 - (cfg.d_conv - 1):S0, :]   # pre-conv, for decode
    xBC = _causal_conv(xBC, params["conv_w"], params["conv_b"]).to(u.dtype)
    x, Bm, Cm = torch.split(xBC, [d_inner, N, N], dim=-1)
    x = x.reshape(Bsz, S, H, P)
    dt = softplus(dt.float() + params["dt_bias"])                  # [B,S,H]
    a = -torch.exp(params["A_log"])                                # [H] < 0

    cdt = u.dtype

    def f32(t):
        """A compute-dtype einsum input widened to fp32 (see the module
        docstring)."""
        return t.to(cdt).float()

    xc = x.reshape(Bsz, nc, Q, H, P).to(cdt)
    Bc = Bm.reshape(Bsz, nc, Q, N).to(cdt)
    Cc = Cm.reshape(Bsz, nc, Q, N).to(cdt)
    dtc = dt.reshape(Bsz, nc, Q, H)

    alpha = a[None, None, None, :] * dtc                   # [B,nc,Q,H] (<=0)
    cum = torch.cumsum(alpha, dim=2)                       # [B,nc,Q,H]
    total = cum[:, :, -1]                                  # [B,nc,H]

    # ---- intra-chunk (quadratic, matmul form) ------------------------------
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # [B,nc,Qi,Qj,H]
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=u.device))
    Lmat = torch.where(causal[None, None, :, :, None], torch.exp(diff),
                       torch.zeros((), device=u.device))
    CB = torch.einsum("bcin,bcjn->bcij", f32(Cc), f32(Bc))  # [B,nc,Q,Q]
    scores = (CB[..., None] * Lmat).to(cdt)                 # [B,nc,Q,Q,H]
    xdt = (xc.float() * dtc[..., None]).to(cdt)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", f32(scores), f32(xdt))

    # ---- chunk states + inter-chunk recurrence -----------------------------
    decay_end = torch.exp(total[:, :, None, :] - cum).to(cdt)
    states = torch.einsum("bcjh,bcjn,bcjhp->cbhpn", f32(decay_end), f32(Bc),
                          f32(xdt)).to(cdt)
    expcum = torch.exp(cum).to(cdt)                        # [B,nc,Q,H]

    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=u.device)
    ys = []
    for c in range(nc):
        y_c = torch.einsum("bin,bhpn,bih->bihp", f32(Cc[:, c]), f32(h),
                           f32(expcum[:, c]))
        ys.append(y_c)
        h = torch.exp(total[:, c])[:, :, None, None] * h + states[c].float()
    y_inter = torch.stack(ys, dim=1)                       # [B,nc,Q,H,P]

    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    y = y + params["D"][None, None, :, None] * x.float()
    y = y.reshape(Bsz, S, d_inner)

    # gate + norm in one fp32 pass, then back to the compute dtype
    y = (y * F.silu(z.float())).to(u.dtype)
    y = rmsnorm(y, params["norm"])
    out = y @ params["out_proj"]
    if S != S0:
        out = out[:, :S0]
    if return_state:
        return out, {"conv": conv_tail.to(u.dtype), "h": h}
    return out


def init_ssm_cache(batch: int, d_model: int, cfg: SSMConfig,
                   dtype: torch.dtype, device: torch.device
                   ) -> Dict[str, torch.Tensor]:
    d_inner = cfg.expand * d_model
    H = cfg.num_heads(d_model)
    N = cfg.d_state
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, d_inner + 2 * N),
                            dtype=dtype, device=device),
        "h": torch.zeros((batch, H, cfg.head_dim, N), dtype=torch.float32,
                         device=device),
    }


def decode_core(params: Params, zxbcdt: torch.Tensor,
                cache: Dict[str, torch.Tensor], cfg: SSMConfig, d_model: int
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Everything between the two decode-step projections: takes the
    in-projection output ``zxbcdt`` [B, 2·d_inner + 2N + H] and the layer's
    recurrent cache; returns the gated, normed ``y`` [B, d_inner] for the
    out projection and the new cache (new tensors). The JIT's SSM templates
    declare the two projections as GEMMs and run this as glue, so the
    recurrence has one copy."""
    Bsz = zxbcdt.shape[0]
    d_inner = cfg.expand * d_model
    H = cfg.num_heads(d_model)
    N = cfg.d_state
    P = cfg.head_dim
    z, xBC, dt = _split_zxbcdt(zxbcdt, d_inner, N)

    # causal conv over the cached window and the new input
    window = torch.cat([cache["conv"],
                        xBC[:, None].to(cache["conv"].dtype)], dim=1)
    conv = torch.einsum("bkc,kc->bc", window.float(),
                        params["conv_w"].float())
    xBC_t = F.silu(conv + params["conv_b"].float())
    new_conv = window[:, 1:]

    x, Bm, Cm = torch.split(xBC_t, [d_inner, N, N], dim=-1)
    x = x.reshape(Bsz, H, P).float()
    dt = softplus(dt.float() + params["dt_bias"])          # [B,H]
    a = -torch.exp(params["A_log"])

    decay = torch.exp(a[None] * dt)                        # [B,H]
    dBx = torch.einsum("bh,bn,bhp->bhpn", dt, Bm.float(), x)
    h = decay[:, :, None, None] * cache["h"] + dBx         # [B,H,P,N]
    y = torch.einsum("bn,bhpn->bhp", Cm.float(), h)
    y = y + params["D"][None, :, None] * x
    y = y.reshape(Bsz, d_inner)

    y = y * F.silu(z.float())
    y = rmsnorm(y.to(zxbcdt.dtype), params["norm"])
    return y, {"conv": new_conv, "h": h}


def ssd_decode_step(params: Params, u: torch.Tensor,
                    cache: Dict[str, torch.Tensor], cfg: SSMConfig
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token recurrent update. u: [B, 1, d_model]."""
    d_model = int(u.shape[2])
    y, new_cache = decode_core(params, u[:, 0] @ params["in_proj"],
                               cache, cfg, d_model)
    return (y @ params["out_proj"])[:, None], new_cache


def ssd_reference(params: Params, u: torch.Tensor, cfg: SSMConfig
                  ) -> torch.Tensor:
    """Naive step-by-step recurrence oracle (for tests)."""
    Bsz, S, d_model = u.shape
    cache = init_ssm_cache(Bsz, d_model, cfg, u.dtype, u.device)
    outs = []
    for t in range(S):
        y, cache = ssd_decode_step(params, u[:, t:t + 1], cache, cfg)
        outs.append(y)
    return torch.cat(outs, dim=1)


__all__ = ["decode_core", "init_mamba", "init_ssm_cache", "softplus",
           "ssd_chunked", "ssd_decode_step", "ssd_reference"]
