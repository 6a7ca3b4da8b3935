"""Decoder-only dense transformer, forward only (the counterpart of the
dense path of ``repro.models.transformer``).

Layers are stacked on a leading axis, as in the reference; a Python loop
over the layers replaces ``lax.scan``. The ``attn_kernel`` hook takes
the flash-attention kernel (``build_model(use_kernels=True)``). Prefill,
decode, MoE, MLA, the vision frontend, soft-capping and the local/global
window alternation (gemma2) wait for a later slice of the port.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as ly


def _check_dense(cfg):
    if (cfg.attn_kind != "gqa" or cfg.moe is not None
            or cfg.frontend is not None or cfg.window_size is not None
            or cfg.attn_softcap is not None
            or cfg.final_softcap is not None):
        raise NotImplementedError(
            f"{cfg.name}: only the dense GQA transformer is ported "
            f"(MoE, MLA, frontends, sliding windows and soft-capping: "
            f"ROADMAP.md queue A item 6)")


def init(cfg, generator, device):
    """f32 parameters of the reference's tree (``layers`` stacked on a
    leading ``n_layers`` axis)."""
    _check_dense(cfg)
    L = (cfg.n_layers,)
    d = cfg.d_model
    layer = {"ln1": ly.rmsnorm_init(d, device, L),
             "ln2": ly.rmsnorm_init(d, device, L),
             "attn": ly.gqa_init(cfg, generator, device, L),
             "mlp": ly.mlp_init(d, cfg.d_ff, generator, device,
                                cfg.gated_mlp, L)}
    params = {
        "embed": ly.uniform_scale((cfg.vocab_size, d), d, generator,
                                  device),
        "layers": layer,
        "final_norm": ly.rmsnorm_init(d, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = ly.dense_init(d, cfg.vocab_size, generator,
                                          device)
    return params


def _block(cfg, x, lp, pos, attn_kernel=None):
    """One decoder block. ``attn_kernel(q, k, v, cap=...)`` on (B, H, L,
    hd) tensors replaces the attention: the reference's gate (no cache,
    no window) always holds here, since this forward has no cache and
    ``_check_dense`` refuses windows."""
    h = ly.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = ly.gqa_qkv(lp["attn"], h, cfg)
    cos, sin = ly.rope_tables(pos, cfg.resolved_head_dim, cfg.rope_theta)
    q = ly.apply_rope(q, cos, sin)
    k = ly.apply_rope(k, cos, sin)
    if attn_kernel is not None:
        o = attn_kernel(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2),
                        cap=cfg.attn_softcap).transpose(1, 2)
    else:
        o = ly.attention(q, k, v, q_pos=pos, kv_pos=pos)
    x = x + ly.gqa_out(lp["attn"], o)
    h = ly.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + ly.mlp(lp["mlp"], h, gated=cfg.gated_mlp,
                      act=torch.nn.functional.silu)


def forward(params, cfg, batch, *, dtype=torch.bfloat16, attn_kernel=None):
    """Teacher-forced full-sequence forward. Returns (logits, aux_loss)."""
    _check_dense(cfg)
    x = params["embed"].to(dtype)[batch["tokens"]]
    pos = torch.arange(x.shape[1], device=x.device)
    for i in range(cfg.n_layers):
        x = _block(cfg, x, ly.layer_slice(params["layers"], i), pos,
                   attn_kernel)
    x = ly.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    w = (params["embed"].T if cfg.tie_embeddings
         else params["lm_head"]).to(x.dtype)
    return x @ w, torch.zeros((), dtype=torch.float32, device=x.device)
