"""Qwen3-MoE 235B-A22B class [hf:Qwen/Qwen3-30B-A3B scaled per assignment].

128 experts, top-8 routing, fine-grained experts (d_ff=1536).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    arch_type="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    moe=MoEConfig(n_experts=128, top_k=8),
    tie_embeddings=False,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-30B-A3B",
    skip_shapes=("long_500k",),
)
