"""InternVL2-26B language backbone (InternLM2-20B class) [arXiv:2404.16821].

VLM: InternViT vision encoder + MLP projector are STUBBED per assignment —
``input_specs()`` supplies 256 precomputed patch embeddings prepended to
the text sequence.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    arch_type="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,          # GQA
    d_ff=16384,
    vocab_size=92553,
    frontend="vision",
    n_frontend_tokens=256,
    tie_embeddings=False,
    rope_theta=1_000_000.0,
    source="arXiv:2404.16821",
    skip_shapes=("long_500k",),   # pure full attention
)
