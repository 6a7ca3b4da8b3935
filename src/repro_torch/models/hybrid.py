"""Zamba2-style hybrid [arXiv:2411.15242]: a Mamba2 backbone with one
SHARED attention block run after every ``attn_every`` SSM blocks, with
norms of its own for each invocation — the counterpart of
``repro.models.hybrid``.

The SSM blocks are stacked ``(G, attn_every, ...)`` with G = n_layers //
attn_every, as in the reference; a Python loop over the groups, and over
the blocks of each, replaces its nested ``lax.scan``. The decode cache is
{"ssm": {"conv": (G, A, B, w-1, conv_dim), "ssm": (G, A, B, H, P, N)
f32}, "k"/"v": (G, B, S, KV, hd)}. Prefill and decode return a new SSM
cache and write the shared block's keys and values into the given k and
v IN PLACE (ROADMAP C.19): prefill from position 0, decode at ``pos``.
The ``ssd_kernel`` hook reaches the forward only, as in the reference
(its registry never hands it to prefill).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as ly
from repro_torch.models.layers import _ssm_dims


def _n_groups(cfg):
    assert cfg.n_layers % cfg.attn_every == 0
    return cfg.n_layers // cfg.attn_every


def init(cfg, generator, device):
    """f32 parameters of the reference's tree."""
    G, d = _n_groups(cfg), cfg.d_model
    lead = (G, cfg.attn_every)
    return {
        "embed": ly.uniform_scale((cfg.vocab_size, d), d, generator,
                                  device),
        "ssm_layers": {"ln": ly.rmsnorm_init(d, device, lead),
                       "mixer": ly.mamba2_init(cfg, generator, device,
                                               lead)},
        "shared_attn": {
            "attn": ly.gqa_init(cfg, generator, device),
            "mlp": ly.mlp_init(d, cfg.d_ff, generator, device,
                               cfg.gated_mlp),
        },
        "inv_norms": {"ln1": ly.rmsnorm_init(d, device, (G,)),
                      "ln2": ly.rmsnorm_init(d, device, (G,))},
        "final_norm": ly.rmsnorm_init(d, device),
    }


def _shared_attn_block(params, cfg, x, ln1, ln2, pos, cache_k, cache_v,
                       cache_pos):
    """The shared block with one invocation's norms. ``cache_k``/
    ``cache_v`` (B, S, KV, hd): this group's cache, written in place at
    ``cache_pos``, or None (the forward)."""
    sp = params["shared_attn"]
    h = ly.rmsnorm(x, ln1, cfg.norm_eps)
    q, k, v = ly.gqa_qkv(sp["attn"], h, cfg)
    cos, sin = ly.rope_tables(pos, cfg.resolved_head_dim, cfg.rope_theta)
    q, k = ly.apply_rope(q, cos, sin), ly.apply_rope(k, cos, sin)
    if cache_k is not None:
        end = cache_pos + x.shape[1]
        cache_k[:, cache_pos:end] = k
        cache_v[:, cache_pos:end] = v
        o = ly.attention(q, cache_k, cache_v, q_pos=pos,
                         kv_pos=torch.arange(cache_k.shape[1],
                                             device=x.device),
                         kv_valid_len=end)
    else:
        o = ly.attention(q, k, v, q_pos=pos, kv_pos=pos)
    x = x + ly.gqa_out(sp["attn"], o)
    h = ly.rmsnorm(x, ln2, cfg.norm_eps)
    return x + ly.mlp(sp["mlp"], h, gated=cfg.gated_mlp, act=F.silu)


def _run(params, cfg, x, ssm_cache, attn_cache, start_pos: int,
         ssd_kernel=None):
    """The G groups in turn: attn_every SSM blocks, then the shared block.

    ``ssm_cache`` None (forward, prefill: a fresh state, the chunked
    scan) or the stacked decode state; ``attn_cache`` None (forward) or
    the {"k", "v"} buffers. Returns (x, the new stacked SSM cache)."""
    pos = start_pos + torch.arange(x.shape[1], device=x.device)
    conv, ssm = [], []
    for g in range(_n_groups(cfg)):
        group = ly.layer_slice(params["ssm_layers"], g)
        g_conv, g_ssm = [], []
        for a in range(cfg.attn_every):
            lp = ly.layer_slice(group, a)
            c = (None if ssm_cache is None
                 else {k: v[g, a] for k, v in ssm_cache.items()})
            h = ly.rmsnorm(x, lp["ln"], cfg.norm_eps)
            y, new_c = ly.mamba2_apply(lp["mixer"], h, cfg, cache=c,
                                       ssd_kernel=ssd_kernel)
            x = x + y
            g_conv.append(new_c["conv"])
            g_ssm.append(new_c["ssm"])
        conv.append(torch.stack(g_conv))
        ssm.append(torch.stack(g_ssm))
        ck, cv = ((None, None) if attn_cache is None
                  else (attn_cache["k"][g], attn_cache["v"][g]))
        x = _shared_attn_block(params, cfg, x, params["inv_norms"]["ln1"][g],
                               params["inv_norms"]["ln2"][g], pos, ck, cv,
                               start_pos)
    return x, {"conv": torch.stack(conv), "ssm": torch.stack(ssm)}


def _logits(params, x, cfg):
    x = ly.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["embed"].T.to(x.dtype)


def forward(params, cfg, batch, *, dtype=torch.bfloat16, moe_groups=1,
            remat=False, ssd_kernel=None):
    """Teacher-forced full-sequence forward. Returns (logits, aux_loss).
    ``moe_groups`` and ``remat`` are unused, as in the reference."""
    x = params["embed"].to(dtype)[batch["tokens"]]
    x, _ = _run(params, cfg, x, None, None, 0, ssd_kernel)
    return _logits(params, x, cfg), torch.zeros((), dtype=torch.float32,
                                                device=x.device)


def init_cache(cfg, batch_size: int, cache_len: int, dtype=torch.bfloat16,
               *, device):
    """The zero decode cache on ``device``."""
    s = cfg.ssm
    _, nheads, conv_dim = _ssm_dims(cfg)
    G, A = _n_groups(cfg), cfg.attn_every
    kv = (G, batch_size, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {
        "ssm": {
            "conv": torch.zeros((G, A, batch_size, s.conv_width - 1,
                                 conv_dim), dtype=dtype, device=device),
            "ssm": torch.zeros((G, A, batch_size, nheads, s.head_dim,
                                s.d_state), dtype=torch.float32,
                               device=device),
        },
        "k": torch.zeros(kv, dtype=dtype, device=device),
        "v": torch.zeros(kv, dtype=dtype, device=device),
    }


def prefill(params, cfg, batch, cache, *, dtype=torch.bfloat16,
            moe_groups=1):
    """Run the prompt from a fresh SSM state, writing the shared block's
    keys and values into ``cache`` from position 0; returns (last-token
    logits (B, 1, V), the cache with the prompt's SSM states)."""
    x = params["embed"].to(dtype)[batch["tokens"]]
    x, ssm = _run(params, cfg, x, None, cache, 0)
    return _logits(params, x[:, -1:], cfg), {"ssm": ssm, "k": cache["k"],
                                             "v": cache["v"]}


def decode_step(params, cfg, tokens, cache, pos, *, dtype=torch.bfloat16,
                moe_groups=1):
    """One token per sequence against the cache. tokens (B, 1); ``pos``
    is the number of tokens already in the cache. Returns (logits (B, 1,
    V), the cache with the new SSM states)."""
    x = params["embed"].to(dtype)[tokens]
    x, ssm = _run(params, cfg, x, cache["ssm"], cache, int(pos))
    return _logits(params, x, cfg), {"ssm": ssm, "k": cache["k"],
                                     "v": cache["v"]}
