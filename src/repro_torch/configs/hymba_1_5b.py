"""Hymba-1.5B — hybrid: parallel attention + mamba heads per layer
[arXiv:2411.13676].

Hymba uses sliding-window attention on most layers with three full-attention
(global) layers; we express that as window 1024 with one global layer per
~11-layer period (layers 10, 21 and the final block of the 32-layer stack).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    window_size=1024,
    global_every=11,
    ssm=SSMConfig(d_state=16, head_dim=64, expand=2, chunk_size=64),
    source="arXiv:2411.13676",
)
