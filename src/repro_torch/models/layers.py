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

from repro_torch.kernels.ref import MASK_VALUE, ssd_intra_chunk_plain


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


def layer_slice(tree, i):
    """Layer ``i`` of parameters stacked on a leading ``n_layers`` axis
    (the Python loop that stands in for ``lax.scan``)."""
    return {k: layer_slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ------------------------------------------------------------ Mamba2 SSD

def _ssm_dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, nheads, conv_dim


def mamba2_init(cfg, generator, device, lead=()):
    s = cfg.ssm
    d = cfg.d_model
    d_inner, nheads, conv_dim = _ssm_dims(cfg)
    d_in_proj = 2 * d_inner + 2 * s.n_groups * s.d_state + nheads
    if torch.device(device).type == "meta":
        u = torch.empty((*lead, nheads), device="meta")
    else:
        u = torch.rand((*lead, nheads), generator=generator, device=device)
    dt = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min))
                   + math.log(s.dt_min))
    a_log = torch.log(torch.arange(1, nheads + 1, dtype=torch.float32,
                                   device=device))
    return {
        "in_proj": dense_init(d, d_in_proj, generator, device, lead),
        "conv_w": uniform_scale((*lead, s.conv_width, conv_dim),
                                s.conv_width, generator, device),
        "conv_b": torch.zeros((*lead, conv_dim), device=device),
        "dt_bias": torch.log(torch.expm1(dt)),      # inverse softplus
        "A_log": a_log.expand(*lead, nheads).clone(),
        "D": torch.ones((*lead, nheads), device=device),
        "norm": rmsnorm_init(d_inner, device, lead),
        "out_proj": dense_init(d_inner, d, generator, device, lead),
    }


def ssd_chunked(x, dt, A, B_, C_, D, chunk, ssd_kernel=None):
    """SSD scan (arXiv:2405.21060 listing 1), fp32 state math.

    x (b,l,h,p) dt (b,l,h) A (h,) B_,C_ (b,l,g,n) D (h,)
    Returns y (b,l,h,p) and final state (b,h,p,n). ``ssd_kernel(xc, dAc,
    Bc, Cc)`` computes the in-chunk term (by default its plain version,
    ``kernels.ref.ssd_intra_chunk_plain``); the recurrence between
    chunks stays here."""
    b, l, h, p = x.shape
    g, n = B_.shape[2], B_.shape[3]
    x0 = x
    rep = h // g

    xb = (x * dt[..., None]).float()
    dA = (dt * A).float()                                 # (b,l,h)

    # pad to a chunk multiple: x=0, dA=0, B=C=0 keeps state/outputs exact
    l_orig = l
    if l % chunk:
        pad = chunk - l % chunk
        padfn = lambda t: F.pad(t, [0, 0] * (t.ndim - 2) + [0, pad])  # noqa: E731
        xb, dA = padfn(xb), padfn(dA)
        B_, C_ = padfn(B_), padfn(C_)
        l += pad
    nc = l // chunk

    def ch(t):                                            # chunkify
        return t.reshape(b, nc, chunk, *t.shape[2:])

    xc, dAc = ch(xb), ch(dA)
    Bc = ch(B_.float()).repeat_interleave(rep, dim=3)     # (b,nc,cl,h,n)
    Cc = ch(C_.float()).repeat_interleave(rep, dim=3)

    dA_cs = torch.cumsum(dAc, dim=2)                      # (b,nc,cl,h)

    Y_diag = (ssd_kernel or ssd_intra_chunk_plain)(xc, dAc, Bc, Cc)

    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)  # (b,nc,cl,h)
    states = torch.einsum("bclhn,bclh,bclhp->bchpn", Bc, decay_states, xc)

    chunk_decay = torch.exp(dA_cs[:, :, -1, :])           # (b,nc,h)

    st = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(st)
        st = st * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                # (b,nc,h,p,n)

    state_decay = torch.exp(dA_cs)                        # (b,nc,cl,h)
    Y_off = torch.einsum("bclhn,bchpn,bclh->bclhp", Cc, prev_states,
                         state_decay)

    y = (Y_diag + Y_off).reshape(b, l, h, p)[:, :l_orig]
    y = y + (D[None, None, :, None] * x0.float())
    return y.to(x0.dtype), st


def mamba2_apply(p, x, cfg, *, cache=None, ssd_kernel=None):
    """Full mamba2 block. cache = {"conv": (b, w-1, conv_dim),
    "ssm": (b,h,p,n)} for single-token decode; None for train/prefill.
    Returns (y, new_cache)."""
    s = cfg.ssm
    d_inner, nheads, conv_dim = _ssm_dims(cfg)
    B, L, _ = x.shape
    proj = x @ p["in_proj"].to(x.dtype)
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner:d_inner + conv_dim]
    dt = proj[..., d_inner + conv_dim:]
    # causal depthwise conv over xbc, as the reference's shifted sum
    # (not F.conv1d: cuDNN convolutions run in TF32 by default)
    w = p["conv_w"].to(x.dtype)                           # (width, conv_dim)
    if cache is None:
        pad = torch.zeros((B, s.conv_width - 1, conv_dim), dtype=x.dtype,
                          device=x.device)
    else:
        pad = cache["conv"].to(x.dtype)
    xp = torch.cat([pad, xbc], dim=1)
    conv = sum(xp[:, i:i + L] * w[i] for i in range(s.conv_width))
    new_conv_state = xp[:, xp.shape[1] - (s.conv_width - 1):]
    conv = F.silu(conv + p["conv_b"].to(x.dtype))

    xs = conv[..., :d_inner].reshape(B, L, nheads, s.head_dim)
    B_ = conv[..., d_inner:d_inner + s.n_groups * s.d_state] \
        .reshape(B, L, s.n_groups, s.d_state)
    C_ = conv[..., d_inner + s.n_groups * s.d_state:] \
        .reshape(B, L, s.n_groups, s.d_state)
    # jax.nn.softplus is logaddexp(x, 0)
    dt = torch.logaddexp(dt.float() + p["dt_bias"],
                         torch.zeros((), device=x.device))  # (B,L,H)
    A = -torch.exp(p["A_log"])                            # (H,)

    if cache is None:
        y, new_ssm = ssd_chunked(xs, dt, A, B_, C_, p["D"], s.chunk,
                                 ssd_kernel=ssd_kernel)
    else:
        # single-step recurrence (L == 1)
        st = cache["ssm"].float()                         # (B,H,P,N)
        dt1 = dt[:, 0]                                    # (B,H)
        dA = torch.exp(dt1 * A[None, :])                  # (B,H)
        xb = xs[:, 0].float() * dt1[..., None]
        rep = nheads // s.n_groups
        Bh = B_[:, 0].repeat_interleave(rep, dim=1).float()
        Ch = C_[:, 0].repeat_interleave(rep, dim=1).float()
        st = st * dA[..., None, None] + torch.einsum("bhp,bhn->bhpn", xb, Bh)
        y1 = torch.einsum("bhpn,bhn->bhp", st, Ch) \
            + p["D"][None, :, None] * xs[:, 0].float()
        y = y1[:, None].to(x.dtype)
        new_ssm = st

    y = y.reshape(B, L, d_inner)
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"].to(x.dtype)
    return out, {"conv": new_conv_state.to(x.dtype), "ssm": new_ssm}
