"""The ``gpt`` family, that of every configuration file without a
``family`` key: the program's dense decoder as the GPT-3 cells state it,
one KV head per query head, the output head tied to the embedding, and a
two-matrix MLP (three with ``gated_mlp``)."""
from __future__ import annotations


def program_config(cfg: dict):
    """The program's ``ModelConfig`` for a configuration file."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(
        name=cfg["name"], arch_type="dense", n_layers=cfg["n_layers"],
        d_model=cfg["d_model"], n_heads=cfg["n_heads"],
        n_kv_heads=cfg["n_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["d_ff"], vocab_size=cfg["vocab_size"],
        tie_embeddings=True, gated_mlp=bool(cfg.get("gated_mlp")),
        rope_theta=cfg["rope_theta"], norm_eps=cfg["norm_eps"],
        source=cfg["source"])


def param_shapes(cfg: dict) -> dict:
    """``{name: (shape, fan_in)}`` of the share's parameters, named as the
    checkpoint names them; ``fan_in`` is None for a norm's scale."""
    d, H, hd = cfg["d_model"], cfg["n_heads"], cfg["head_dim"]
    L, ff, V = cfg["n_layers"], cfg["d_ff"], cfg["vocab_size"]
    shapes = {
        "embed": ((V, d), d),
        "final_norm": ((d,), None),
        "layers/attn/wq": ((L, d, H * hd), d),
        "layers/attn/wk": ((L, d, H * hd), d),
        "layers/attn/wv": ((L, d, H * hd), d),
        "layers/attn/wo": ((L, H * hd, d), H * hd),
        "layers/ln1": ((L, d), None),
        "layers/ln2": ((L, d), None),
        "layers/mlp/wi": ((L, d, ff), d),
        "layers/mlp/wo": ((L, ff, d), ff),
    }
    if cfg.get("gated_mlp"):
        shapes["layers/mlp/wg"] = ((L, d, ff), d)
    return shapes


def matmul_params(cfg: dict) -> int:
    """Parameters that enter a matrix product once per token: every
    projection, and the tied embedding as the output head."""
    d, H, hd = cfg["d_model"], cfg["n_heads"], cfg["head_dim"]
    mlp = (3 if cfg.get("gated_mlp") else 2) * d * cfg["d_ff"]
    return cfg["vocab_size"] * d + cfg["n_layers"] * (4 * d * H * hd + mlp)


def attention_flops(cfg: dict) -> int:
    """Forward FLOPs of the score and value products of one sequence:
    2 * hd multiply-adds per kept (query, key) pair and head, twice."""
    S = cfg["seq_len"]
    pairs = S * (S + 1) // 2
    return cfg["n_layers"] * cfg["n_heads"] * 2 * (2 * cfg["head_dim"]
                                                   * pairs)


def train_flops_per_step(cfg: dict, rows: int) -> int:
    """Forward and backward (3x the forward) of ``rows`` sequences."""
    per_seq = 2 * matmul_params(cfg) * cfg["seq_len"] + attention_flops(cfg)
    return 3 * rows * per_seq
