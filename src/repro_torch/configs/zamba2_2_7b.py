"""Zamba2-2.7B [arXiv:2411.15242] — Mamba2 backbone + shared attention
block invoked every 6 SSM blocks (see DESIGN.md deviations)."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    arch_type="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,            # shared attention block's MLP
    vocab_size=32000,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, n_groups=1, chunk=256),
    attn_every=6,
    tie_embeddings=True,
    source="arXiv:2411.15242",
    # long_500k valid: SSM backbone is sub-quadratic; the 9 shared-attn
    # invocations decode against a sharded 500k cache.
)
