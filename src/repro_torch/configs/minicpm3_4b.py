"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B] — Multi-head Latent Attention."""
from repro_torch.configs.base import ModelConfig, MLAConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    arch_type="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    attn_kind="mla",
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                  qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
    tie_embeddings=True,
    source="hf:openbmb/MiniCPM3-4B",
    skip_shapes=("long_500k",),   # MLA compresses KV but is full attention
)
