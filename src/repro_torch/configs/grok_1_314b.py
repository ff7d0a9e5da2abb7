"""Grok-1 (314B) — MoE with 8 experts, top-2 routing [hf:xai-org/grok-1]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    arch_type="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    moe=MoEConfig(num_experts=8, top_k=2),
    source="hf:xai-org/grok-1",
)
