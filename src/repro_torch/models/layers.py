"""Shared model building blocks (dense parts), plain functions on
tensors — the counterpart of ``repro.models.layers``.

Parameters are nested dicts of tensors in the reference's layout:
per-layer parameters STACKED on a leading ``(n_layers, ...)`` axis, and
weights ``(d_in, d_out)`` used as ``x @ W`` (not ``nn.Linear``'s
``(out, in)``), so checkpoints cross-load by name and shape. Weights are
cast to the activations' dtype at use, as in the reference.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

MASK_VALUE = -1e30


def uniform_scale(shape, fan_in, generator, device, dtype=torch.float32):
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) drawn from ``generator``
    (``meta`` device: shape only)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return u.mul_(2 * scale).sub_(scale)


def dense_init(d_in, d_out, generator, device, lead=()):
    return uniform_scale((*lead, d_in, d_out), d_in, generator, device)


# ---------------------------------------------------------------- RMSNorm

def rmsnorm_init(d, device, lead=()):
    return torch.ones((*lead, d), dtype=torch.float32, device=device)


def rmsnorm(x, w, eps=1e-5):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * w).to(dt)


# ------------------------------------------------------------------ RoPE

def rope_tables(positions, head_dim, theta):
    """positions (...,) -> cos,sin (..., head_dim//2) in fp32."""
    half = head_dim // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=positions.device)
                      * (math.log(theta) / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (..., L, H, hd); cos/sin (..., L, hd//2) — rotate-half pairs."""
    dt = x.dtype
    x = x.float()
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)


# ------------------------------------------------------------- Attention

def softcap(x, cap):
    return cap * torch.tanh(x / cap) if cap else x


def attention(q, k, v, *, q_pos, kv_pos, causal=True,
              window: Optional[int] = None, cap: Optional[float] = None):
    """GQA attention in plain torch (not SDPA), as ``ly.attention``.

    q: (B, Lq, H, hd); k,v: (B, Lk, KV, hd); ``q_pos``/``kv_pos`` are
    position vectors for the causal and sliding-window masks. Masked
    logits take MASK_VALUE (−1e30), not −inf, as in the reference."""
    B, Lq, H, hd = q.shape
    KV = k.shape[2]
    rep = H // KV
    qf = q.reshape(B, Lq, KV, rep, hd).float()
    kf = k.float()
    scores = torch.einsum("bqghd,bkgd->bghqk", qf, kf) / math.sqrt(hd)
    scores = softcap(scores, cap)
    mask = torch.ones((Lq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= kv_pos[None, :]
    if window is not None:
        mask &= q_pos[:, None] - kv_pos[None, :] < window
    scores = torch.where(mask, scores, MASK_VALUE)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bghqk,bkgd->bqghd", probs, v)
    return out.reshape(B, Lq, H, v.shape[-1])


def gqa_init(cfg, generator, device, lead=()):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = {
        "wq": dense_init(d, cfg.n_heads * hd, generator, device, lead),
        "wk": dense_init(d, cfg.n_kv_heads * hd, generator, device, lead),
        "wv": dense_init(d, cfg.n_kv_heads * hd, generator, device, lead),
        "wo": dense_init(cfg.n_heads * hd, d, generator, device, lead),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                            ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros((*lead, width * hd), device=device)
    return p


def gqa_qkv(p, x, cfg):
    B, L, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return (q.reshape(B, L, cfg.n_heads, hd),
            k.reshape(B, L, cfg.n_kv_heads, hd),
            v.reshape(B, L, cfg.n_kv_heads, hd))


def gqa_out(p, o):
    B, L, H, hd = o.shape
    return o.reshape(B, L, H * hd) @ p["wo"].to(o.dtype)


# ------------------------------------------------------------------- MLP

def mlp_init(d, ff, generator, device, gated=True, lead=()):
    p = {"wi": dense_init(d, ff, generator, device, lead)}
    if gated:
        p["wg"] = dense_init(d, ff, generator, device, lead)
    p["wo"] = dense_init(ff, d, generator, device, lead)
    return p


def gelu(x):
    """``jax.nn.gelu``'s default (tanh approximation)."""
    return F.gelu(x, approximate="tanh")


def mlp(p, x, gated=True, act=gelu):
    h = x @ p["wi"].to(x.dtype)
    if gated:
        h = act(x @ p["wg"].to(x.dtype)) * h
    else:
        h = act(h)
    return h @ p["wo"].to(x.dtype)
