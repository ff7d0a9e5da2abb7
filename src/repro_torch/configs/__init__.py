"""Config registry: 10 assigned architectures + reduced smoke variants.

``get_config(arch_id)`` returns the exact assigned config; ``smoke_config``
returns a reduced variant of the same family (≤2 layers, d_model ≤ 512,
≤4 experts) used by the CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig, MoEConfig, SSMConfig

from repro_torch.configs.yi_9b import CONFIG as _yi_9b
from repro_torch.configs.internvl2_2b import CONFIG as _internvl2_2b
from repro_torch.configs.grok_1_314b import CONFIG as _grok_1_314b
from repro_torch.configs.granite_34b import CONFIG as _granite_34b
from repro_torch.configs.stablelm_12b import CONFIG as _stablelm_12b
from repro_torch.configs.mamba2_2_7b import CONFIG as _mamba2_2_7b
from repro_torch.configs.whisper_tiny import CONFIG as _whisper_tiny
from repro_torch.configs.hymba_1_5b import CONFIG as _hymba_1_5b
from repro_torch.configs.llama4_maverick_400b_a17b import CONFIG as _llama4
from repro_torch.configs.gemma3_1b import CONFIG as _gemma3_1b

REGISTRY: Dict[str, ModelConfig] = {
    c.name: c
    for c in [
        _yi_9b,
        _internvl2_2b,
        _grok_1_314b,
        _granite_34b,
        _stablelm_12b,
        _mamba2_2_7b,
        _whisper_tiny,
        _hymba_1_5b,
        _llama4,
        _gemma3_1b,
    ]
}

ARCH_IDS = tuple(REGISTRY)

# (arch, shape) pairs excluded from the dry-run per DESIGN.md §6: long_500k
# requires sub-quadratic attention and is skipped for pure full-attention
# architectures (and for whisper's 448-position decoder family).
SKIPPED_PAIRS = frozenset(
    (arch, "long_500k")
    for arch in (
        "yi-9b",
        "granite-34b",
        "stablelm-12b",
        "internvl2-2b",
        "grok-1-314b",
        "whisper-tiny",
    )
)


def get_config(arch_id: str) -> ModelConfig:
    try:
        return REGISTRY[arch_id]
    except KeyError:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(REGISTRY)}"
        ) from None


def pair_is_supported(arch_id: str, shape_name: str) -> bool:
    return (arch_id, shape_name) not in SKIPPED_PAIRS


def smoke_config(arch_id: str) -> ModelConfig:
    """Reduced variant of the same family for CPU smoke tests."""
    full = get_config(arch_id)
    kw = dict(
        name=full.name + "-smoke",
        num_layers=2,
        d_model=min(full.d_model, 128),
        vocab_size=min(full.vocab_size, 512),
    )
    if full.arch_type != "ssm":
        kw.update(
            num_heads=4,
            num_kv_heads=min(full.num_kv_heads, 2) if full.num_kv_heads > 1 else 1,
            d_ff=min(full.d_ff, 256),
            head_dim=32,
        )
    if full.moe is not None:
        kw["moe"] = MoEConfig(
            num_experts=min(full.moe.num_experts, 4),
            top_k=min(full.moe.top_k, 2),
        )
    if full.ssm is not None:
        kw["ssm"] = SSMConfig(
            d_state=min(full.ssm.d_state, 16),
            head_dim=32,
            expand=2,
            chunk_size=16,
        )
    if full.window_size:
        kw["window_size"] = 32
        kw["global_every"] = 2
    if full.arch_type == "audio":
        kw["num_encoder_layers"] = 2
        kw["encoder_seq_len"] = 24
    if full.arch_type == "vlm":
        kw["num_patch_tokens"] = 8
    return dataclasses.replace(full, **kw)


__all__ = [
    "ARCH_IDS",
    "INPUT_SHAPES",
    "InputShape",
    "ModelConfig",
    "MoEConfig",
    "REGISTRY",
    "SKIPPED_PAIRS",
    "SSMConfig",
    "get_config",
    "pair_is_supported",
    "smoke_config",
]
