"""Decoder-only transformer for the dense and moe families (the
counterpart of ``repro.models.transformer``, less gemma2's local/global
windows and soft-caps, MLA and the vision frontend).

Layers are stacked on a leading axis, as in the reference; a Python loop
over the layers replaces ``lax.scan``. The KV cache is stacked the same
way: {"k": (L, B, S, KV, hd), "v": ...}. Prefill and decode write the new
keys and values into the given cache IN PLACE and return it (the
reference returns a new cache; its serving loop donates the old one, so
XLA does the same). The ``attn_kernel`` hook takes the flash-attention
kernel (``build_model(use_kernels=True)``); ``moe_kernel(p, h, cfg)``
replaces the MoE layer, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as ly


def check_ported(cfg):
    """Refuse what this module does not port yet, naming the ROADMAP.md
    queue A item that brings it."""
    missing = []
    if cfg.attn_kind == "mla":
        missing.append("MLA (item 6f)")
    if cfg.frontend == "vision":
        missing.append("the vision frontend (item 6g)")
    elif cfg.frontend is not None:
        missing.append(f"the {cfg.frontend} frontend (item 6h)")
    if (cfg.window_size is not None or cfg.attn_softcap is not None
            or cfg.final_softcap is not None):
        missing.append("sliding windows and soft-caps (item 6e)")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (ROADMAP.md "
            f"queue A)")


def init(cfg, generator, device):
    """f32 parameters of the reference's tree (``layers`` stacked on a
    leading ``n_layers`` axis; a MoE layer's experts stacked (L, E, ...))."""
    check_ported(cfg)
    L = (cfg.n_layers,)
    d = cfg.d_model
    layer = {"ln1": ly.rmsnorm_init(d, device, L),
             "ln2": ly.rmsnorm_init(d, device, L),
             "attn": ly.gqa_init(cfg, generator, device, L)}
    if cfg.moe is not None:
        layer["mlp"] = ly.moe_init(cfg, generator, device, L)
    else:
        layer["mlp"] = ly.mlp_init(d, cfg.d_ff, generator, device,
                                   cfg.gated_mlp, L)
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


def _block(cfg, x, lp, pos, *, cache_k=None, cache_v=None, cache_pos=None,
           moe_groups=1, attn_kernel=None, moe_kernel=None):
    """One decoder block; returns (x, aux). ``cache_k``/``cache_v`` (B, S,
    KV, hd): this layer's cache, written in place at ``cache_pos``.
    ``attn_kernel(q, k, v, cap=...)`` on (B, H, L, hd) tensors replaces
    the attention under the reference's gate: no cache (``check_ported``
    refuses windows)."""
    h = ly.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = ly.gqa_qkv(lp["attn"], h, cfg)
    cos, sin = ly.rope_tables(pos, cfg.resolved_head_dim, cfg.rope_theta)
    q = ly.apply_rope(q, cos, sin)
    k = ly.apply_rope(k, cos, sin)
    if cache_k is not None:
        end = cache_pos + x.shape[1]
        cache_k[:, cache_pos:end] = k
        cache_v[:, cache_pos:end] = v
        o = ly.attention(q, cache_k, cache_v, q_pos=pos,
                         kv_pos=torch.arange(cache_k.shape[1],
                                             device=x.device),
                         kv_valid_len=end)
    elif attn_kernel is not None:
        o = attn_kernel(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2),
                        cap=cfg.attn_softcap).transpose(1, 2)
    else:
        o = ly.attention(q, k, v, q_pos=pos, kv_pos=pos)
    x = x + ly.gqa_out(lp["attn"], o)
    h = ly.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    if cfg.moe is None:
        # silu for the plain MLP too (ROADMAP C.18: the reference's GPT-3
        # MLP runs silu, though its config says GELU)
        return x + ly.mlp(lp["mlp"], h, gated=cfg.gated_mlp,
                          act=F.silu), None
    if moe_kernel is not None:
        out, aux = moe_kernel(lp["mlp"], h, cfg)
    else:
        out, aux = ly.moe_apply(lp["mlp"], h, cfg, n_groups=moe_groups,
                                impl=cfg.moe_impl)
    return x + out, aux


def _layers(params, cfg, x, pos, cache=None, cache_pos=None, **kw):
    """Every block in turn; returns (x after the final norm, summed aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        lp = ly.layer_slice(params["layers"], i)
        if cache is not None:
            kw.update(cache_k=cache["k"][i], cache_v=cache["v"][i],
                      cache_pos=cache_pos)
        x, a = _block(cfg, x, lp, pos, **kw)
        if a is not None:
            aux = aux + a
    return ly.rmsnorm(x, params["final_norm"], cfg.norm_eps), aux


def _unembed(params, cfg, x):
    w = (params["embed"].T if cfg.tie_embeddings
         else params["lm_head"]).to(x.dtype)
    return x @ w


def forward(params, cfg, batch, *, dtype=torch.bfloat16, moe_groups=1,
            attn_kernel=None, moe_kernel=None):
    """Teacher-forced full-sequence forward. Returns (logits, aux_loss),
    the aux loss summed over the layers."""
    check_ported(cfg)
    x = params["embed"].to(dtype)[batch["tokens"]]
    pos = torch.arange(x.shape[1], device=x.device)
    x, aux = _layers(params, cfg, x, pos, moe_groups=moe_groups,
                     attn_kernel=attn_kernel, moe_kernel=moe_kernel)
    return _unembed(params, cfg, x), aux


def init_cache(cfg, batch_size: int, cache_len: int, dtype=torch.bfloat16,
               *, device):
    """The zero KV cache on ``device``, stacked over the layers."""
    check_ported(cfg)
    shape = (cfg.n_layers, batch_size, cache_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _with_cache(params, cfg, tokens, cache, start_pos, dtype, moe_groups):
    x = params["embed"].to(dtype)[tokens]
    pos = start_pos + torch.arange(x.shape[1], device=x.device)
    x, _ = _layers(params, cfg, x, pos, cache, start_pos,
                   moe_groups=moe_groups)
    return x


def prefill(params, cfg, batch, cache, *, dtype=torch.bfloat16,
            moe_groups=1):
    """Run the prompt, writing its keys and values into ``cache`` from
    position 0; returns (last-token logits (B, 1, V), the cache)."""
    x = _with_cache(params, cfg, batch["tokens"], cache, 0, dtype,
                    moe_groups)
    return _unembed(params, cfg, x[:, -1:]), cache


def decode_step(params, cfg, tokens, cache, pos, *, dtype=torch.bfloat16,
                moe_groups=1):
    """One token per sequence against the cache. tokens (B, 1); ``pos``
    is the number of tokens already in the cache. Returns (logits (B, 1,
    V), the cache)."""
    x = _with_cache(params, cfg, tokens, cache, int(pos), dtype, moe_groups)
    return _unembed(params, cfg, x), cache
