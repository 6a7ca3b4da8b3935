"""Mamba2-370M [arXiv:2405.21060] — SSD (state-space duality), attn-free."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    arch_type="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    attn_kind="none",
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1, chunk=256),
    tie_embeddings=True,
    source="arXiv:2405.21060",
    # all shapes valid: SSM decode state is O(1) in sequence length
)
