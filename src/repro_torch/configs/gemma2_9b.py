"""Gemma2-9B [arXiv:2408.00118].

Alternating local (sliding-window 4096) / global attention, attention and
final logit soft-capping, GeGLU MLP.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    arch_type="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    attn_softcap=50.0,
    final_softcap=30.0,
    window_size=4096,
    global_every=2,        # every 2nd layer is global, others sliding-window
    tie_embeddings=True,
    source="arXiv:2408.00118",
    # long_500k allowed: local layers are sliding-window (sub-quadratic);
    # global layers decode against the sharded 500k cache (O(seq) per token).
)
