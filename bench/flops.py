"""Model FLOPs of one training step of a configuration's share: what the
forward and backward passes need, with nothing recomputed and causal
attention counted over the pairs it keeps."""
from __future__ import annotations


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


def peak(device_name: str, key: str = "bf16_flops_per_s"):
    """The published peak of a device by its ``torch.cuda`` name, or None
    for a device the table does not hold."""
    import json
    import os
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "peaks.json")) as f:
        return json.load(f).get(device_name, {}).get(key)
