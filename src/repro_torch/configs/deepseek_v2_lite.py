"""DeepSeek-V2-Lite [hf:deepseek-ai/DeepSeek-V2-Lite, config.json;
arXiv:2405.04434] — multi-head latent attention without a query LoRA,
one leading dense layer, then DeepSeekMoE layers of 64 fine-grained
routed experts (top-6 by softmax, gates not renormalised) beside 2
shared experts, a per-sequence balance loss.

Not in ``ARCH_IDS``: the reference package has no such config, and the
tests that walk that list hold the port against it. The rotary dims
take the released config's YaRN scaling (factor 40 over 4,096 original
positions, mscale 0.707), pairing them rotate-half where the released
code interleaves them (a fixed permutation of those dims of ``wq`` and
``wkv_a``). ``aux_loss_alpha`` 0.001 is the released code's value; the
catalog copy of the config lacks it."""
from repro_torch.configs.base import (DeepSeekMoEConfig, ModelConfig,
                                      YarnMLAConfig)

CONFIG = ModelConfig(
    name="deepseek-v2-lite",
    arch_type="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,
    vocab_size=102400,
    attn_kind="mla",
    mla=YarnMLAConfig(q_lora_rank=None, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128, factor=40.0,
                      original_max_position_embeddings=4096, beta_fast=32.0,
                      beta_slow=1.0, mscale=0.707, mscale_all_dim=0.707),
    moe=DeepSeekMoEConfig(n_experts=64, top_k=6, aux_loss_coef=0.001,
                          moe_intermediate_size=1408, n_shared_experts=2,
                          first_k_dense_replace=1),
    moe_impl="dropless",
    tie_embeddings=False,
    rope_theta=10000.0,
    norm_eps=1e-6,
    source="hf:deepseek-ai/DeepSeek-V2-Lite",
    skip_shapes=("long_500k",),
)
