"""Llama-4-Maverick (400B total / 17B active) — MoE, 128 experts top-1, early
fusion, chunked attention (iRoPE: 3 local : 1 global, chunk 8192)
[hf:meta-llama/Llama-4-Scout-17B-16E family]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    arch_type="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    window_size=8192,
    global_every=4,
    moe=MoEConfig(num_experts=128, top_k=1),
    rope_theta=500000.0,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
