"""StableLM-2-1.6B [hf:stabilityai/stablelm-2-1_6b]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    arch_type="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,         # MHA
    d_ff=5632,
    vocab_size=100352,
    tie_embeddings=False,
    source="hf:stabilityai/stablelm-2-1_6b",
    skip_shapes=("long_500k",),
)
