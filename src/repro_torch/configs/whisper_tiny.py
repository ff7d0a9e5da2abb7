"""Whisper-tiny — encoder/decoder with conv/mel frontend (stubbed)
[arXiv:2212.04356].

The conv+mel frontend is a stub per the assignment: ``input_specs()`` provides
precomputed frame embeddings [batch, 1500, d_model] for the encoder.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    arch_type="audio",
    num_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    num_encoder_layers=4,
    encoder_seq_len=1500,
    source="arXiv:2212.04356",
)
