"""Gemma-3-1B — dense decoder, 5:1 local:global attention, window 1024, 128k+
context [hf:google/gemma-3-1b-pt]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    arch_type="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    d_ff=6912,
    vocab_size=262144,
    head_dim=256,
    window_size=1024,
    global_every=6,
    rope_theta=1000000.0,
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt",
)
