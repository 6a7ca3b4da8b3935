"""The ``deepseek_v2`` family: DeepSeek-V2's decoder as its released
``config.json`` states it (the file's keys are that config's), run by the
program's MoE transformer: multi-head latent attention (here without a
query LoRA), ``first_k_dense_replace`` leading dense layers of
``intermediate_size``, then DeepSeekMoE layers of routed experts of
``moe_intermediate_size`` beside ``n_shared_experts`` shared ones, an
untied head.

The chip holds one expert-parallel rank's share: ``n_routed_experts`` of
the ``router_experts`` each MoE layer routes over, from
``first_held_expert``; the router keeps its published width and experts
per token. ``n_layers`` is the depth run (the file keeps the published
``num_hidden_layers``). The rotary dims take the config's YaRN scaling
(``rope_scaling``), as the released model computes at every length."""
from __future__ import annotations

#: what the program's layer computes; anything else is refused
_REQUIRED = {"hidden_act": "silu", "attention_bias": False,
             "scoring_func": "softmax", "topk_method": "greedy",
             "n_group": 1, "topk_group": 1, "moe_layer_freq": 1,
             "norm_topk_prob": False, "routed_scaling_factor": 1,
             "seq_aux": True}


def _check(cfg: dict):
    bad = {k: cfg.get(k) for k, v in _REQUIRED.items() if cfg.get(k) != v}
    if (cfg.get("rope_scaling") or {}).get("type") != "yarn":
        bad["rope_scaling"] = cfg.get("rope_scaling")
    if bad:
        raise ValueError(f"{cfg['name']}: the program computes {_REQUIRED}, "
                         f"not {bad}")


def program_config(cfg: dict):
    """The program's ``ModelConfig`` for a configuration file."""
    from repro_torch.configs.base import (DeepSeekMoEConfig, ModelConfig,
                                          YarnMLAConfig)
    _check(cfg)
    yarn = {k: v for k, v in cfg["rope_scaling"].items() if k != "type"}
    return ModelConfig(
        name=cfg["name"], arch_type="moe", n_layers=cfg["n_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        attn_kind="mla",
        mla=YarnMLAConfig(q_lora_rank=cfg["q_lora_rank"],
                          kv_lora_rank=cfg["kv_lora_rank"],
                          qk_nope_head_dim=cfg["qk_nope_head_dim"],
                          qk_rope_head_dim=cfg["qk_rope_head_dim"],
                          v_head_dim=cfg["v_head_dim"], **yarn),
        moe=DeepSeekMoEConfig(
            n_experts=cfg["router_experts"],
            top_k=cfg["num_experts_per_tok"],
            aux_loss_coef=cfg["aux_loss_alpha"],
            moe_intermediate_size=cfg["moe_intermediate_size"],
            n_shared_experts=cfg["n_shared_experts"],
            first_k_dense_replace=cfg["first_k_dense_replace"],
            first_held_expert=cfg["first_held_expert"],
            n_held_experts=cfg["n_routed_experts"]),
        moe_impl="dropless", tie_embeddings=cfg["tie_word_embeddings"],
        gated_mlp=True, rope_theta=float(cfg["rope_theta"]),
        norm_eps=cfg["rms_norm_eps"], source=cfg["source"])


def _attn_shapes(cfg: dict, stack: str, L: int) -> dict:
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    vd, r = cfg["v_head_dim"], cfg["kv_lora_rank"]
    a = f"{stack}/attn/"
    return {
        a + "wq": ((L, d, H * (nope + rope)), d),
        a + "wkv_a": ((L, d, r + rope), d),
        a + "kv_norm": ((L, r), None),
        a + "wkv_b": ((L, r, H * (nope + vd)), r),
        a + "wo": ((L, H * vd, d), H * vd),
        f"{stack}/ln1": ((L, d), None),
        f"{stack}/ln2": ((L, d), None),
    }


def _swiglu_shapes(prefix: str, lead: tuple, d: int, ff: int) -> dict:
    return {prefix + "wi": ((*lead, d, ff), d),
            prefix + "wg": ((*lead, d, ff), d),
            prefix + "wo": ((*lead, ff, d), ff)}


def param_shapes(cfg: dict) -> dict:
    """``{name: (shape, fan_in)}`` of the share's parameters, named as the
    checkpoint names them (the leading dense layers under
    ``dense_layers``, the MoE layers under ``layers``); ``fan_in`` is None
    for a norm's scale."""
    if cfg["q_lora_rank"] is not None:
        raise ValueError("the family's shapes are MLA's without a query "
                         "LoRA")
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    Ld = cfg["first_k_dense_replace"]
    Lm = cfg["n_layers"] - Ld
    f = cfg["moe_intermediate_size"]
    shapes = {"embed": ((V, d), d), "final_norm": ((d,), None),
              "lm_head": ((d, V), d)}
    if Ld:
        shapes.update(_attn_shapes(cfg, "dense_layers", Ld))
        shapes.update(_swiglu_shapes("dense_layers/mlp/", (Ld,), d,
                                     cfg["intermediate_size"]))
    shapes.update(_attn_shapes(cfg, "layers", Lm))
    shapes["layers/mlp/router"] = ((Lm, d, cfg["router_experts"]), d)
    shapes.update(_swiglu_shapes("layers/mlp/",
                                 (Lm, cfg["n_routed_experts"]), d, f))
    if cfg["n_shared_experts"]:
        shapes.update(_swiglu_shapes("layers/mlp/shared/", (Lm,), d,
                                     cfg["n_shared_experts"] * f))
    return shapes


def _attn_matmul_params(cfg: dict) -> int:
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    vd, r = cfg["v_head_dim"], cfg["kv_lora_rank"]
    return (d * H * (nope + rope) + d * (r + rope) + r * H * (nope + vd)
            + H * vd * d)


def matmul_params(cfg: dict) -> int:
    """Parameters that enter a matrix product once per token, the routed
    experts at their expectation: each token's ``num_experts_per_tok``
    pairs land on a held expert with the share ``n_routed_experts /
    router_experts``, whatever the program's routing does."""
    d = cfg["hidden_size"]
    Ld = cfg["first_k_dense_replace"]
    Lm = cfg["n_layers"] - Ld
    f = cfg["moe_intermediate_size"]
    routed = (cfg["num_experts_per_tok"] * cfg["n_routed_experts"]
              / cfg["router_experts"])
    moe = (d * cfg["router_experts"] + 3 * d * cfg["n_shared_experts"] * f
           + routed * 3 * d * f)
    dense = 3 * d * cfg["intermediate_size"]
    return round(cfg["vocab_size"] * d
                 + cfg["n_layers"] * _attn_matmul_params(cfg)
                 + Ld * dense + Lm * moe)


def mla_attention_flops(cfg: dict) -> int:
    """Forward and backward FLOPs of one sequence's attention: per causal
    pair and head, the forward's two products (q.k over nope + rope, p.v
    over v_head_dim) and the backward's four (dV, dP, dQ, dK), 2 FLOP a
    multiply-add. The model's work, whatever a kernel pads."""
    S = cfg["seq_len"]
    pairs = S * (S + 1) // 2
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    return (cfg["n_layers"] * cfg["num_attention_heads"] * pairs
            * 3 * 2 * (qk + cfg["v_head_dim"]))


def mla_attention_bytes(cfg: dict) -> int:
    """The least bytes the attention kernels move for one sequence,
    forward and backward, in bf16: the forward reads q, k, v and writes o
    and each row's log-sum-exp; the backward reads q, k, v, o, dO and the
    log-sum-exp, writes dq, dk, dv, and writes and reads each row's D."""
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    vd = cfg["v_head_dim"]
    fwd = 2 * (2 * qk + 2 * vd) + 4
    bwd = 2 * (2 * qk + 3 * vd) + 2 * (2 * qk + vd) + 12
    return (cfg["n_layers"] * cfg["seq_len"] * cfg["num_attention_heads"]
            * (fwd + bwd))


def train_flops_per_step(cfg: dict, rows: int) -> int:
    """Forward and backward (3x the forward) of ``rows`` sequences."""
    return rows * (3 * 2 * matmul_params(cfg) * cfg["seq_len"]
                   + mla_attention_flops(cfg))
