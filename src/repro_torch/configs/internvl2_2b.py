"""InternVL2-2B — InternViT frontend (stubbed) + InternLM2 backbone
[arXiv:2404.16821].

Per the assignment, the VLM entry specifies the transformer backbone only;
``input_specs()`` provides precomputed patch embeddings of the right shape.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    arch_type="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    num_patch_tokens=256,
    source="arXiv:2404.16821",
)
