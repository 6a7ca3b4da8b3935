"""Whisper-small transformer backbone [arXiv:2212.04356].

Encoder-decoder; mel-spectrogram + conv frontend STUBBED per assignment —
``input_specs()`` supplies precomputed 1500-frame embeddings (B,1500,768).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    arch_type="encdec",
    n_layers=12,           # decoder layers
    n_enc_layers=12,
    n_enc_ctx=1500,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    frontend="audio",
    tie_embeddings=True,
    source="arXiv:2212.04356",
    skip_shapes=("long_500k",),   # audio enc-dec: no 500k-token decode
)
