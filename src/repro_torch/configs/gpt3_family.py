"""The paper's own models (Table 2): GPT-3 dense family + 1.8B MoE.

Hyper-parameters from [arXiv:2005.14165] Table 2.1 and DeepSpeed-MoE
[PMLR v162]. These drive the paper-faithful benchmarks (Figs. 2, 9, 10,
11, 12; Table 1). Checkpoint sizes reproduce the paper's Table 2 via the
~14 B/param mixed-precision-Adam rule (§2.1.3).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

# name -> (layers, d_model, heads, d_ff, MP degree, GBS, paper ckpt GB)
_GPT3_TABLE = {
    "gpt3_0_7b": (24, 1536, 16, 6144, 1, 256, 10),
    "gpt3_1_3b": (24, 2048, 16, 8192, 2, 512, 17),
    "gpt3_2_7b": (32, 2560, 32, 10240, 4, 512, 35),
    "gpt3_6_7b": (32, 4096, 32, 16384, 8, 1024, 88),
    "gpt3_13b":  (40, 5140, 40, 20560, 16, 1024, 173),
}

GPT3_VOCAB = 50257


def _mk(key: str) -> ModelConfig:
    L, d, h, ff, mp, gbs, ckpt_gb = _GPT3_TABLE[key]
    return ModelConfig(
        name=key.replace("_", "-"),
        arch_type="dense",
        n_layers=L, d_model=d, n_heads=h, n_kv_heads=h,
        d_ff=ff, vocab_size=GPT3_VOCAB,
        tie_embeddings=True,
        gated_mlp=False,           # GPT-3 uses plain GELU MLP
        source="arXiv:2005.14165 (paper Table 2)",
        skip_shapes=("long_500k",),
    )


GPT3_CONFIGS = {k: _mk(k) for k in _GPT3_TABLE}

GPT3_MOE_1_8B = ModelConfig(
    name="gpt3-1.8b-moe",
    arch_type="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=GPT3_VOCAB,
    moe=MoEConfig(n_experts=16, top_k=1),   # EP=16 in the paper
    tie_embeddings=True,
    source="DeepSpeed-MoE, PMLR v162 (paper Table 2)",
    skip_shapes=("long_500k",),
)

# paper Table 2 metadata: MP degree, global batch size, checkpoint GB
PAPER_TABLE2 = {
    **{k: {"mp": v[4], "gbs": v[5], "ckpt_gb": v[6]} for k, v in _GPT3_TABLE.items()},
    "gpt3_1_8b_moe": {"mp": 16, "gbs": 256, "ckpt_gb": 67},
}


def get_paper_config(key: str) -> ModelConfig:
    key = key.replace("-", "_").replace(".", "_")
    if key == "gpt3_1_8b_moe":
        return GPT3_MOE_1_8B
    return GPT3_CONFIGS[key]
