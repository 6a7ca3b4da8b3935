"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base].

Dense-MoE hybrid: 128-expert top-2 MoE with a parallel dense residual MLP.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    arch_type="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    moe=MoEConfig(n_experts=128, top_k=2, dense_residual=True,
                  dense_ff=4864),
    tie_embeddings=False,
    source="hf:Snowflake/snowflake-arctic-base",
    skip_shapes=("long_500k",),
)
