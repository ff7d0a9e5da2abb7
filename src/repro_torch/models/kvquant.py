"""int8 KV-cache quantization, the counterpart of the JAX package's
``models/kvquant.py``.

Decode reads the whole KV cache every step, so halving the cache's bytes
halves decode's dominant memory term. The scheme: symmetric int8 per
(position, head), with the scale over head_dim stored beside the values
(the last axis, where the attention dot contracts).

  quantize:   scale = max|x| / 127 over head_dim;  q = round(x / scale)
  dequantize: x ≈ q * scale

``q`` is computed against the fp32 scale; the scale is stored in
``scale_dtype`` only afterwards. ``torch.round`` rounds half to even, as
``jnp.round`` does, so the int8 values and the stored scales are bitwise
the JAX package's on the same input.

Exposed through ``Model(..., kv_quant=True)``: ``init_cache`` stores k / v
as int8 plus ``k_scale`` / ``v_scale`` in the param dtype, and attention
dequantizes on read.
"""
from __future__ import annotations

from typing import Tuple

import torch


def quantize(x: torch.Tensor, scale_dtype: torch.dtype = torch.bfloat16
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [..., hd] -> (int8 [..., hd], scale [..., 1])."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax / 127.0, 1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale.to(scale_dtype)


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale.float()).to(dtype)
