"""The plain reference of the served models: GQA decoder layers with a
gated MLP (dense) or a top-k mixture of experts with GShard capacity
(MoE), in float32, written from the equations with plain PyTorch.

It imports nothing of the program and reads nothing the program made: it
takes the benchmark's own weight tensors (bf16 values, exact in fp32) and
the benchmark's prompts and served tokens.

The equations, as the configuration files state the repo's model:

* embedding ``E[tok] · sqrt(d)``; RMSNorm ``x / rms(x) · (1 + g)``;
* attention: rotary embedding on q and k (the first and second halves of
  a head rotate as a pair, ``theta^(-i / (hd/2))``), causal softmax of
  ``q·kᵀ / sqrt(hd)``, query head ``h`` reading kv head ``h // (H/Hkv)``;
* dense FFN ``(silu(x Wg) ⊙ x Wu) Wd``;
* MoE FFN: router ``softmax(x R)``, the top-k experts (ties to the lower
  index), their probabilities renormalized; the tokens of one routing
  group (a prompt, or one decode step's whole batch) are ranked within
  each expert in (token, choice) order and an expert keeps the first
  ``C = max(int(T·k·cf / E), k)``; a dropped choice adds nothing;
* logits ``rmsnorm(x) · U`` over the padded vocabulary.

Precision. ``fp32``: every matmul is float32-accurate. On the card an fp32
activation is split into three bf16 parts whose sum is exact, and the
three products with the bf16 weight run as one bf16 GEMM with an fp32
result (TF32 and reduced-precision reductions off): the weights are read
once, in the dtype they are stored in. ``fp8``: the control of the
correctness check, one precision below the configuration's bf16: every
weight matrix and every matmul input rounded to float8 e4m3 with one
scale per output column and per row (the router, fp32 in the
configuration, stays fp32).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

FP8_MAX = 448.0
ATTN_CHUNK = 512


def _fp32_exact_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` to float32 accuracy for fp32 ``x`` [M, k] and bf16 ``w``
    [k, n]."""
    if not x.is_cuda:
        return x @ w.float()
    x1 = x.to(torch.bfloat16)
    r = x - x1.float()
    x2 = r.to(torch.bfloat16)
    x3 = (r - x2.float()).to(torch.bfloat16)
    parts = torch.cat([x1, x2, x3])[None]
    out = torch.bmm(parts, w[None], out_dtype=torch.float32)[0]
    M = x.shape[0]
    return out[:M] + out[M:2 * M] + out[2 * M:]


def _fp8_round(x: torch.Tensor, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` (fp32) as e4m3 values (held in bf16, which holds them exactly)
    and the fp32 scale along ``dim`` that brings each slice's largest
    magnitude to e4m3's largest."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / FP8_MAX
    q = (x / scale).to(torch.float8_e4m3fn).to(torch.bfloat16)
    return q, scale


class Linear:
    """One weight matrix [k, n] as the reference reads it."""

    def __init__(self, w: torch.Tensor, precision: str):
        self.precision = precision
        if precision == "fp8":
            self.w, self.col_scale = _fp8_round(w.float(), dim=0)
        else:
            self.w, self.col_scale = w, None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        x = x.reshape(-1, shape[-1]).float()
        if self.precision == "fp8":
            xq, row_scale = _fp8_round(x, dim=1)
            y = _fp32_exact_mm(xq.float(), self.w) * row_scale * self.col_scale
        else:
            y = _fp32_exact_mm(x, self.w)
        return y.reshape(*shape[:-1], y.shape[-1])


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * (1.0 + g.float())


def rope_tables(hd: int, theta: float, positions: int,
                device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos / sin [positions, hd/2] (angles in float64, then fp32)."""
    half = hd // 2
    freqs = 1.0 / (theta ** (np.arange(half, dtype=np.float64) / half))
    ang = np.arange(positions, dtype=np.float64)[:, None] * freqs
    return (torch.from_numpy(np.cos(ang).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(ang).astype(np.float32)).to(device))


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
         ) -> torch.Tensor:
    """x [..., hd] rotated by cos / sin broadcastable to [..., hd/2]."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class Reference:
    """The model of one configuration over one weight set.

    ``prompt(tokens)`` is the causal forward of one sequence (one MoE
    routing group): its hidden states' logits at ``logit_rows`` and its
    per-layer k / v. ``decode(...)`` is one step of a batch of sequences
    against their caches (the batch one MoE routing group)."""

    def __init__(self, model: Dict, params: Dict, precision: str = "fp32",
                 max_positions: int = 8192):
        self.m = model
        self.precision = precision
        d = model["hidden_size"]
        self.d, self.L = d, model["num_hidden_layers"]
        self.H, self.Hkv = model["num_attention_heads"], \
            model["num_key_value_heads"]
        self.hd = model["head_dim"]
        self.eps = model["rms_norm_eps"]
        self.moe = model.get("moe")
        dev = params["embed"].device
        self.device = dev
        lin = lambda w: Linear(w, precision)
        if precision == "fp8":
            q, s = _fp8_round(params["embed"].float(), dim=1)
            self.embed = (q, s)
        else:
            self.embed = (params["embed"], None)
        self.unembed = lin(params["unembed"])
        self.final_norm = params["final_norm"]
        b = params["blocks"]
        self.layers = []
        for l in range(self.L):
            layer = {"ln1": b["ln1"][l], "ln2": b["ln2"][l],
                     **{k: lin(b["attn"][k][l])
                        for k in ("wq", "wk", "wv", "wo")}}
            if self.moe:
                E = self.moe["num_local_experts"]
                layer["router"] = b["moe"]["router"][l]
                layer["experts"] = [
                    {k: lin(b["moe"][k][l, e])
                     for k in ("w_gate", "w_up", "w_down")}
                    for e in range(E)]
            else:
                layer.update({k: lin(b["mlp"][k][l])
                              for k in ("w_gate", "w_up", "w_down")})
            self.layers.append(layer)
        self.cos, self.sin = rope_tables(self.hd, model["rope_theta"],
                                         max_positions, dev)

    # ------------------------------------------------------------------
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        table, scale = self.embed
        x = table[tokens].float()
        if scale is not None:
            x = x * scale[tokens]
        return x * math.sqrt(self.d)

    def _ffn(self, layer: Dict, h: torch.Tensor) -> torch.Tensor:
        """The layer's FFN on h [T, d]; the T tokens are one MoE group."""
        if not self.moe:
            return layer["w_down"](torch.nn.functional.silu(
                layer["w_gate"](h)) * layer["w_up"](h))
        E = self.moe["num_local_experts"]
        k = self.moe["num_experts_per_tok"]
        T = h.shape[0]
        C = max(int(T * k * self.moe["capacity_factor"] / E), k)
        probs = torch.softmax(h @ layer["router"].float(), dim=-1)
        top, experts = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
        top, experts = top[:, :k], experts[:, :k]
        top = top / top.sum(-1, keepdim=True)
        flat = experts.reshape(-1)                       # t·k + j order
        contrib = torch.zeros(T * k, self.d, device=h.device)
        for e in range(E):
            idx = torch.nonzero(flat == e).flatten()[:C]  # kept, in order
            if idx.numel() == 0:
                continue
            xe = h[idx // k]
            ex = layer["experts"][e]
            contrib[idx] = ex["w_down"](torch.nn.functional.silu(
                ex["w_gate"](xe)) * ex["w_up"](xe))
        contrib = contrib.reshape(T, k, self.d) * top[..., None]
        y = torch.zeros(T, self.d, device=h.device)
        for j in range(k):
            y = y + contrib[:, j]
        return y

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.unembed(rmsnorm(x, self.final_norm, self.eps))

    # ------------------------------------------------------------------
    @torch.no_grad()
    def prompt(self, tokens: torch.Tensor, logit_rows: torch.Tensor
               ) -> Tuple[torch.Tensor, list]:
        """Causal forward of ``tokens`` [S]. Returns (logits [n, V] at
        ``logit_rows``, [(k, v)] per layer, each [Hkv, S, hd] fp32)."""
        S = tokens.shape[0]
        G = self.H // self.Hkv
        x = self._embed(tokens)
        cos, sin = self.cos[:S, None, :], self.sin[:S, None, :]
        kvs = []
        for layer in self.layers:
            h = rmsnorm(x, layer["ln1"], self.eps)
            q = rope(layer["wq"](h).view(S, self.H, self.hd), cos, sin)
            kk = rope(layer["wk"](h).view(S, self.Hkv, self.hd), cos, sin)
            v = layer["wv"](h).view(S, self.Hkv, self.hd)
            kvs.append((kk.transpose(0, 1), v.transpose(0, 1)))
            out = torch.empty(S, self.H, self.hd, device=x.device)
            kh = kk.transpose(0, 1)                       # [Hkv, S, hd]
            vh = v.transpose(0, 1)
            for s0 in range(0, S, ATTN_CHUNK):
                s1 = min(S, s0 + ATTN_CHUNK)
                qc = q[s0:s1].view(s1 - s0, self.Hkv, G, self.hd)
                sc = torch.einsum("shgd,htd->hgst", qc, kh[:, :s1]) \
                    / math.sqrt(self.hd)
                rows = torch.arange(s0, s1, device=x.device)[:, None]
                cols = torch.arange(s1, device=x.device)[None, :]
                sc = sc.masked_fill(cols > rows, float("-inf"))
                p = torch.softmax(sc, dim=-1)
                out[s0:s1] = torch.einsum("hgst,htd->shgd", p, vh[:, :s1]) \
                    .reshape(s1 - s0, self.H, self.hd)
            x = x + layer["wo"](out.reshape(S, self.H * self.hd))
            x = x + self._ffn(layer, rmsnorm(x, layer["ln2"], self.eps))
        return self._logits(x[logit_rows]), kvs

    @torch.no_grad()
    def decode(self, tokens: torch.Tensor, pos: torch.Tensor,
               kc: torch.Tensor, vc: torch.Tensor) -> torch.Tensor:
        """One step of B rows: ``tokens`` [B] at positions ``pos`` [B]
        against caches ``kc`` / ``vc`` [L, B, Hkv, T, hd] (fp32), into
        which it writes each row's new k / v at its position. Returns the
        logits [B, V]."""
        B = tokens.shape[0]
        G = self.H // self.Hkv
        x = self._embed(tokens)
        cos, sin = self.cos[pos][:, None, :], self.sin[pos][:, None, :]
        T = int(pos.max()) + 1
        rows = torch.arange(B, device=x.device)
        valid = torch.arange(T, device=x.device)[None, :] <= pos[:, None]
        for l, layer in enumerate(self.layers):
            h = rmsnorm(x, layer["ln1"], self.eps)
            q = rope(layer["wq"](h).view(B, self.H, self.hd), cos, sin)
            kc[l, rows, :, pos] = rope(
                layer["wk"](h).view(B, self.Hkv, self.hd), cos, sin)
            vc[l, rows, :, pos] = layer["wv"](h).view(B, self.Hkv, self.hd)
            qg = q.view(B, self.Hkv, G, self.hd)
            sc = torch.einsum("bhgd,bhtd->bhgt", qg, kc[l, :, :, :T]) \
                / math.sqrt(self.hd)
            sc = sc.masked_fill(~valid[:, None, None, :], float("-inf"))
            p = torch.softmax(sc, dim=-1)
            o = torch.einsum("bhgt,bhtd->bhgd", p, vc[l, :, :, :T])
            x = x + layer["wo"](o.reshape(B, self.H * self.hd))
            x = x + self._ffn(layer, rmsnorm(x, layer["ln2"], self.eps))
        return self._logits(x)


def gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's logit lies below the row's best: [n] fp32."""
    best = logits.max(dim=-1).values
    return best - logits.gather(-1, tokens[:, None].long())[:, 0]


def exact_fp32_products() -> None:
    """Keep every fp32 product fp32 on the card: no TF32, no reduced-
    precision reductions in the bf16 GEMMs of the exact split."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
