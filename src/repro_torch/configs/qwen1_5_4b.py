"""Qwen1.5-4B class [hf:Qwen/Qwen1.5-0.5B family] — QKV bias."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    arch_type="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=False,
    source="hf:Qwen/Qwen1.5-0.5B",
    skip_shapes=("long_500k",),
)
