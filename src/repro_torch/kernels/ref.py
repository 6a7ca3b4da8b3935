"""Plain PyTorch versions of every kernel (the correctness contract).
They mirror ``repro.kernels.ref`` (but ``adam_plain``, whose kernel has
no TPU counterpart) and are what the kernel wrappers run for tensors on
the CPU; on the card the CUDA kernels are held against them."""
from __future__ import annotations

import math

import torch

#: masked attention logits: -1e30, not -inf, as in the reference
MASK_VALUE = -1e30
LOG2E = 1.4426950408889634
#: same-width integer views for the bitwise block compare
_INTS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def ckpt_pack_plain(x2d, *, out_dtype=torch.bfloat16, scale=1.0):
    """(packed (n, block) out_dtype, amax (n,) f32) of ``f32(x) * scale``."""
    xf = x2d.to(torch.float32) * scale
    return xf.to(out_dtype), xf.abs().amax(dim=1)


def ckpt_quant_plain(x2d, amax=None):
    """(q (n, block) int8, scale (n,) f32): per row, ``scale = amax / 127``
    where the row's f32 abs-max is > 0 (else 1, a NaN amax included) and
    ``q = int8(clip(round_half_even(f32(x) / scale), -127, 127))``, the
    arithmetic of the reference's ``core.quant._blockwise``. ``amax``
    (f32, one per row) skips the reduction. Both divisors are tensors on
    x's device: on the card a division by a Python number is a product
    with its reciprocal, which is one ulp off on some inputs."""
    xf = x2d.to(torch.float32)
    if amax is None:
        amax = xf.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / amax.new_full((), 127.0), 1.0)
    q = (xf / scale[:, None]).round_().clamp_(-127, 127).to(torch.int8)
    return q, scale


def ckpt_pack_dirty_plain(x2d, prev2d, *, out_dtype=None, scale=1.0):
    """Pack + per-block BITWISE change mask against the previous packed
    image (NaN-stable, like the host byte compare in
    ``delta.dirty_byte_spans``). The identity pack (same dtype, scale 1)
    is a bit copy into NEW storage: the result becomes the next
    baseline and must not alias a tensor the optimizer updates in
    place."""
    out_dtype = x2d.dtype if out_dtype is None else out_dtype
    xf = x2d.to(torch.float32) * scale
    if out_dtype == x2d.dtype and float(scale) == 1.0:
        y = x2d.clone()
    else:
        y = xf.to(out_dtype)
    ints = _INTS[y.element_size()]
    mask = (y.view(ints) != prev2d.view(ints)).any(dim=1).to(torch.int32)
    return y, xf.abs().amax(dim=1), mask


def flash_attention_plain(q, k, v, *, causal=True, window=None, cap=None,
                          lse=False):
    """q (B, H, Lq, hd); k (B, KV, Lk, hd), v (B, KV, Lk, hd_v) -> (B, H,
    Lq, hd_v) in q's dtype, with the Pallas kernel's arithmetic: f32 scores scaled by
    1/sqrt(hd), masked logits at -1e30, p kept in f32 against an f32 v.
    A row with no valid key averages v over the Lk keys, as
    ``repro.kernels.ref.flash_attention_ref`` does. With ``lse``, returns
    (out, each row's base-2 log-sum-exp of the scaled, masked scores, f32
    (B, H, Lq)): what the backward takes."""
    B, H, Lq, hd = q.shape
    KV, Lk = k.shape[1], k.shape[2]
    rep = H // KV
    kk = k.repeat_interleave(rep, dim=1).float()
    vv = v.repeat_interleave(rep, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * (1.0 / math.sqrt(hd))
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    qpos = torch.arange(Lq, device=q.device)[:, None]
    kpos = torch.arange(Lk, device=q.device)[None, :]
    mask = torch.ones((Lq, Lk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    s = torch.where(mask, s, MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)
    return (out, torch.logsumexp(s, dim=-1) * LOG2E) if lse else out


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, causal=True):
    """The backward kernels' arithmetic in plain PyTorch: (dq, dk, dv) in
    the dtypes of q, k and v, from the forward's output and base-2
    log-sum-exp (its first Lq rows: the kernel's are padded). S = Q Kᵀ in
    f32 of the upcast inputs, P = exp2(S · scale · log2 e − LSE) (0 where
    masked), dV = Pᵀ dO with P rounded to v's dtype first, dP = dO Vᵀ in
    f32, D = rowsum(dO ∘ O), dS = P ∘ (dP − D); dQ = dS K and dK = dSᵀ Q
    times the scale, with dS taken as a bf16 hi + lo pair for bf16 inputs
    (the kernels' two tensor-core products; about 2^-17 relative per
    element, where a single bf16 dS would be 2^-9). KV heads sum the
    gradients of their group. v and dout may have a head dim of their
    own (MLA's 128 against q and k's 192); the scale is q's."""
    B, H, Lq, hd = q.shape
    KV, Lk = k.shape[1], k.shape[2]
    rep = H // KV
    scale = 1.0 / math.sqrt(hd)
    qf, dof = q.float(), dout.float()
    kf = k.repeat_interleave(rep, dim=1).float()
    vf = v.repeat_interleave(rep, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    p = torch.exp2(s * (scale * LOG2E) - lse[..., :Lq, None])
    if causal:
        qpos = torch.arange(Lq, device=q.device)[:, None]
        p = torch.where(qpos >= torch.arange(Lk, device=q.device), p, 0.0)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(v.dtype).float(), dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - (dof * out.float()).sum(-1, keepdim=True))
    if q.dtype == torch.bfloat16:
        hi = ds.to(torch.bfloat16).float()
        ds = hi + (ds - hi).to(torch.bfloat16).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale

    def group(x):            # (B, H, Lk, ·) -> (B, KV, Lk, ·)
        return x.reshape(B, KV, rep, Lk, x.shape[-1]).sum(2)
    return dq.to(q.dtype), group(dk).to(k.dtype), group(dv).to(v.dtype)


def segsum(x):
    """x (..., l) -> (..., l, l) lower-triangular segment sums,
    ``out[i, j] = x[j+1] + ... + x[i]`` (0 on the diagonal, -inf above
    it), exp-able."""
    l = x.shape[-1]
    xx = x.unsqueeze(-1).expand(*x.shape, l)             # xx[..., i, j] = x[i]
    ones = torch.ones((l, l), dtype=torch.bool, device=x.device)
    xx = torch.where(torch.tril(ones, -1), xx, 0.0)
    out = torch.cumsum(xx, dim=-2)
    return torch.where(torch.tril(ones), out, -torch.inf)


def ssd_intra_chunk_plain(xc, dAc, Bc, Cc):
    """xc (b, nc, cl, h, p); dAc (b, nc, cl, h); Bc, Cc (b, nc, cl, h, n)
    -> Y_diag (b, nc, cl, h, p) float32: ``((C Bᵀ) ∘ exp(segsum(dA))) X``
    per (batch, chunk, head)."""
    xc, dAc, Bc, Cc = (t.float() for t in (xc, dAc, Bc, Cc))
    # exp(-inf) = 0 on the upper triangle, so L is already masked
    L = torch.exp(segsum(dAc.permute(0, 1, 3, 2)))       # (b,nc,h,cl,cl)
    scores = torch.einsum("bclhn,bcshn->bchls", Cc, Bc)
    return torch.einsum("bchls,bchls,bcshp->bclhp", scores, L, xc)


@torch.no_grad()
def adam_plain(cfg, grads, params, master, m, v, scale, lr, b1c, b2c):
    """The mixed-precision Adam update of each leaf, in place, in plain
    PyTorch ops: the arithmetic that the fused kernel reproduces bit for
    bit on the card. ``scale`` (the gradient's multiplier), ``lr``,
    ``b1c`` (1 - b1^t) and ``b2c`` are 0-d f32 tensors; b1, b2, eps and
    weight_decay come from ``cfg``."""
    for g, p, mw, mm, vv in zip(grads, params, master, m, v):
        g = g.float() * scale
        mm.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        vv.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
        update = (mm / b1c) / (torch.sqrt(vv / b2c) + cfg.eps)
        mw.sub_(lr * (update + cfg.weight_decay * mw))
        p.copy_(mw)
