"""StableLM-2-12B — dense decoder with GQA [hf:stabilityai/stablelm-2-1_6b
family]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    arch_type="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    source="hf:stabilityai/stablelm-2-1_6b",
)
