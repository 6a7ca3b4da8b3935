"""Shared model building blocks (dense, MLA, MoE and Mamba2 parts), plain
functions on tensors — the counterpart of ``repro.models.layers``.

Parameters are nested dicts of tensors in the reference's layout:
per-layer parameters STACKED on a leading ``(n_layers, ...)`` axis, and
weights ``(d_in, d_out)`` used as ``x @ W`` (not ``nn.Linear``'s
``(out, in)``), so checkpoints cross-load by name and shape. Weights are
cast to the activations' dtype at use, as in the reference.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

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
              window: Optional[int] = None, cap: Optional[float] = None,
              kv_valid_len=None):
    """GQA attention in plain torch (not SDPA), as ``ly.attention``.

    q: (B, Lq, H, hd); k,v: (B, Lk, KV, hd); ``q_pos``/``kv_pos`` are
    position vectors for the causal and sliding-window masks;
    ``kv_valid_len`` masks the cache slots at or beyond it (decode).
    Masked logits take MASK_VALUE (−1e30), not −inf, as in the
    reference."""
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
    if kv_valid_len is not None:
        mask &= (kv_pos < kv_valid_len)[None, :]
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


# ------------------------------------------------------------------- MLA

def mla_init(cfg, generator, device, lead=()):
    m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": dense_init(d, m.q_lora_rank, generator, device, lead),
        "q_norm": rmsnorm_init(m.q_lora_rank, device, lead),
        "wq_b": dense_init(m.q_lora_rank, H * qk, generator, device, lead),
        "wkv_a": dense_init(d, m.kv_lora_rank + m.qk_rope_head_dim,
                            generator, device, lead),
        "kv_norm": rmsnorm_init(m.kv_lora_rank, device, lead),
        "wkv_b": dense_init(m.kv_lora_rank,
                            H * (m.qk_nope_head_dim + m.v_head_dim),
                            generator, device, lead),
        "wo": dense_init(H * m.v_head_dim, d, generator, device, lead),
    }


def _f32_einsum(eq, a, b):
    """An einsum of compute-dtype operands summed in f32: the reference's
    ``preferred_element_type=jnp.float32`` (the products of bf16 values
    are exact in f32)."""
    return torch.einsum(eq, a.float(), b.float())


def mla_attention(p, x, cfg, pos, cache=None, cache_pos=None,
                  absorb=False):
    """Multi-head latent attention, the reference's ``mla_attention``. The
    cache holds the COMPRESSED latent (B, S, kv_lora_rank + rope_dim),
    normalised at write; ``cache`` is this layer's, written in place at
    ``cache_pos``. pos: (L,) query positions. Returns (out, the cache, or
    the new entry without one).

    absorb=True attends in latent space: wkv_b's key half is folded into
    the query and its value half applied after, so per-position K and V
    are never expanded from the cache. Its score and latent products take
    compute-dtype operands summed in f32, as the reference's."""
    m, H = cfg.mla, cfg.n_heads
    B, L, _ = x.shape
    nope, rope_d, vd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    rank = m.kv_lora_rank

    q = rmsnorm(x @ p["wq_a"].to(x.dtype), p["q_norm"], cfg.norm_eps)
    q = (q @ p["wq_b"].to(x.dtype)).reshape(B, L, H, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]

    kv_a = x @ p["wkv_a"].to(x.dtype)                     # (B,L,rank+rope)
    latent, k_rope_flat = kv_a[..., :rank], kv_a[..., rank:]

    cos, sin = rope_tables(pos, rope_d, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope_flat[:, :, None, :], cos, sin)  # (B,L,1,rope)
    # norm at write: the cache holds the normalised latent
    latent = rmsnorm(latent, p["kv_norm"], cfg.norm_eps)
    new_entry = torch.cat([latent, k_rope[:, :, 0, :]], dim=-1)

    if cache is not None:
        valid = cache_pos + L
        cache[:, cache_pos:valid] = new_entry
        full = cache
        kv_pos = torch.arange(cache.shape[1], device=x.device)
    else:
        full, kv_pos, valid = new_entry, pos, None

    latent_all = full[..., :rank]
    k_rope_all = full[..., rank:]

    if absorb:
        wkv = p["wkv_b"].to(x.dtype).reshape(rank, H, nope + vd)
        w_uk, w_uv = wkv[..., :nope], wkv[..., nope:]
        q_lat = torch.einsum("blhn,rhn->blhr", q_nope, w_uk)
        s_lat = _f32_einsum("blhr,bsr->bhls", q_lat, latent_all)
        s_rope = _f32_einsum("blhn,bsn->bhls", q_rope,
                             k_rope_all.to(x.dtype))
        s = (s_lat + s_rope) / math.sqrt(nope + rope_d)
        mask = pos[:, None] >= kv_pos[None, :]
        if valid is not None:
            mask &= (kv_pos < valid)[None, :]
        s = torch.where(mask, s, MASK_VALUE)
        probs = torch.softmax(s, dim=-1)
        o_lat = _f32_einsum("bhls,bsr->blhr", probs.to(x.dtype), latent_all)
        o = torch.einsum("blhr,rhv->blhv", o_lat.to(x.dtype), w_uv)
    else:
        kv = (latent_all @ p["wkv_b"].to(x.dtype)).reshape(B, -1, H,
                                                           nope + vd)
        k_nope, v = kv[..., :nope], kv[..., nope:]
        k = torch.cat([k_nope, k_rope_all[:, :, None, :].expand(
            *k_nope.shape[:3], rope_d)], dim=-1)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        o = attention(qq, k, v, q_pos=pos, kv_pos=kv_pos,
                      kv_valid_len=valid)
    out = o.reshape(B, L, H * vd) @ p["wo"].to(x.dtype)
    return out, (cache if cache is not None else new_entry)


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


# ------------------------------------------------------------------- MoE

def moe_init(cfg, generator, device, lead=()):
    e, d, ff = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
    p = {
        "router": dense_init(d, e, generator, device, lead),
        "wi": uniform_scale((*lead, e, d, ff), d, generator, device),
        "wg": uniform_scale((*lead, e, d, ff), d, generator, device),
        "wo": uniform_scale((*lead, e, ff, d), ff, generator, device),
    }
    if cfg.moe.dense_residual:
        p["dense"] = mlp_init(d, cfg.moe.dense_ff or cfg.d_ff, generator,
                              device, lead=lead)
    return p


class Routing(NamedTuple):
    """The router's decision for ``G`` groups of ``T`` tokens each."""
    G: int
    T: int
    C: int               # expert capacity per group
    probs: torch.Tensor  # (G, T, E) f32 softmax
    gate_v: torch.Tensor  # (G, T, K) f32, renormalised over the top k
    gate_i: torch.Tensor  # (G, T, K) int64 expert index, best first


def moe_route(p, x, cfg, *, n_groups=1, capacity_factor=None) -> Routing:
    """Group the tokens, route them in f32 and size the capacity exactly as
    the reference does (layers.py:309-322). The top k is taken from a
    STABLE descending sort, so that ties go to the lower expert index as
    ``lax.top_k`` sends them (``torch.topk`` promises no order on ties);
    the gate values are gathered from ``probs`` and stay differentiable."""
    B, L, _ = x.shape
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    if capacity_factor is None:
        capacity_factor = cfg.moe.capacity_factor
    G = min(n_groups, B) if B * L % min(n_groups, B * L) == 0 else 1
    G = max(G, 1)
    T = (B * L) // G
    C = max(int(T * K / E * capacity_factor), 1)
    logits = x.reshape(G, T, -1).float() @ p["router"].float()   # (G,T,E)
    probs = torch.softmax(logits, dim=-1)
    gate_i = torch.sort(probs.detach(), dim=-1, descending=True,
                        stable=True).indices[..., :K]
    gate_v = probs.gather(-1, gate_i)
    gate_v = gate_v / gate_v.sum(-1, keepdim=True).clamp(min=1e-9)
    return Routing(G, T, C, probs, gate_v, gate_i)


def _moe_aux(cfg, r: Routing, onehot):
    """Switch-style load-balance loss: E · Σ_e (mean prob) · (fraction
    routed)."""
    me = r.probs.mean(dim=(0, 1))                          # (E,)
    ce = onehot.sum(2).mean(dim=(0, 1))
    return cfg.moe.aux_loss_coef * cfg.moe.n_experts * torch.sum(me * ce)


def _expert_ffn(p, ex_in, lead: str):
    """SwiGLU of every expert on its (…, C, D) slots; ``lead`` names the
    einsum axes before the expert's."""
    dt = ex_in.dtype
    h = torch.einsum(f"{lead}ecd,edf->{lead}ecf", ex_in, p["wi"].to(dt))
    g = torch.einsum(f"{lead}ecd,edf->{lead}ecf", ex_in, p["wg"].to(dt))
    return torch.einsum(f"{lead}ecf,efd->{lead}ecd", F.silu(g) * h,
                        p["wo"].to(dt))


def moe_apply(p, x, cfg, *, n_groups=1, capacity_factor=None,
              impl="einsum"):
    """Mixture-of-experts layer, the reference's ``moe_apply``. Returns
    (out, aux_loss).

    impl="einsum": GShard capacity dispatch through one-hot einsums; a
    (token, k) past its expert's capacity, in arrival order, is dropped.
    impl="sorted": tokens routed by a stable sort and gather/scatter
    (``moe_apply_sorted``); the same output when capacity is ample, and
    drops by token index within an expert when it is not."""
    if impl == "sorted":
        return moe_apply_sorted(p, x, cfg, n_groups=n_groups,
                                capacity_factor=capacity_factor)
    B, L, D = x.shape
    E = cfg.moe.n_experts
    r = moe_route(p, x, cfg, n_groups=n_groups,
                  capacity_factor=capacity_factor)
    G, T, C = r.G, r.T, r.C
    xt = x.reshape(G, T, D)
    K = r.gate_i.shape[-1]
    onehot = F.one_hot(r.gate_i, E).float()                # (G,T,K,E)
    # position of each (token, k) inside its expert's capacity buffer
    pos = (torch.cumsum(onehot.reshape(G, T * K, E), dim=1)
           .reshape(G, T, K, E) - 1.0)
    keep = (pos < C) & (onehot > 0)
    pos = pos.clamp(0, C - 1).long()
    # (G,T,K,E,C) 0/1 slots in the compute dtype (exact), as the reference
    slot = F.one_hot(pos, C).to(x.dtype) * keep[..., None].to(x.dtype)
    dispatch = slot.sum(2)                                 # (G,T,E,C)
    # the reference's preferred_element_type=f32: products of compute-
    # dtype values, summed over k in f32
    combine = torch.einsum("gtke,gtkec->gtec",
                           (r.gate_v[..., None] * onehot).to(x.dtype).float(),
                           slot.float())
    # the aux loss and the dense residual come before the combine, the
    # last product: a recompute under ``checkpoint`` stops after the last
    # tensor the backward saved, so the combine is not run again (as XLA
    # drops it from the reference's rematerialized block)
    aux = _moe_aux(cfg, r, onehot)
    res = (mlp(p["dense"], x, gated=cfg.gated_mlp, act=F.silu)
           if cfg.moe.dense_residual else None)
    ex_in = torch.einsum("gtec,gtd->gecd", dispatch, xt)
    ex_out = _expert_ffn(p, ex_in, "g")
    out = torch.einsum("gtec,gecd->gtd", combine.to(x.dtype), ex_out)
    out = out.reshape(B, L, D)
    if res is not None:
        out = out + res
    return out, aux


def moe_apply_sorted(p, x, cfg, *, n_groups=1, capacity_factor=None):
    """Sort-based MoE dispatch (see ``moe_apply``): per group, the (token,
    k) pairs sorted stably by expert; a pair at position ≥ C in its expert
    is dropped. The reference's ``.at[dest].set(mode="drop")`` is a write
    into a buffer with one spare slot, cut off after."""
    B, L, D = x.shape
    E = cfg.moe.n_experts
    r = moe_route(p, x, cfg, n_groups=n_groups,
                  capacity_factor=capacity_factor)
    G, T, C = r.G, r.T, r.C
    K = r.gate_i.shape[-1]
    xt = x.reshape(G, T, D)
    dev = x.device
    TK, EC = T * K, E * C
    outs = []
    for g in range(G):
        flat_e = r.gate_i[g].reshape(TK)
        order = torch.argsort(flat_e, stable=True)          # by expert
        sorted_e = flat_e[order]
        counts = torch.bincount(flat_e, minlength=E)
        starts = torch.cumsum(counts, 0) - counts           # (E,)
        pos_in_e = torch.arange(TK, device=dev) - starts[sorted_e]
        keep = pos_in_e < C
        slot = sorted_e * C + pos_in_e.clamp(0, C - 1)
        dest = torch.where(keep, slot, EC)                 # EC: dropped
        src_tok = torch.full((EC + 1,), T, dtype=torch.long, device=dev)
        src_tok[dest] = order // K
        xg_pad = torch.cat([xt[g], xt.new_zeros(1, D)])
        ex_in = xg_pad[src_tok[:EC]].reshape(E, C, D)
        ex_out = _expert_ffn(p, ex_in, "")
        slot_tk = torch.full((TK,), EC, dtype=torch.long, device=dev)
        slot_tk[order] = dest
        out_pad = torch.cat([ex_out.reshape(EC, D), ex_out.new_zeros(1, D)])
        picked = out_pad[slot_tk].reshape(T, K, D)
        outs.append(torch.einsum("tk,tkd->td", r.gate_v[g].to(x.dtype),
                                 picked))
    out = torch.stack(outs).reshape(B, L, D)
    aux = _moe_aux(cfg, r, F.one_hot(r.gate_i, E).float())
    if cfg.moe.dense_residual:
        out = out + mlp(p["dense"], x, gated=cfg.gated_mlp, act=F.silu)
    return out, aux


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
    if g == 1:     # one group: every head reads it in place (stride 0)
        Bc = ch(B_.float()).expand(b, nc, chunk, h, n)    # (b,nc,cl,h,n)
        Cc = ch(C_.float()).expand(b, nc, chunk, h, n)
    else:
        Bc = ch(B_.float()).repeat_interleave(rep, dim=3)
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
