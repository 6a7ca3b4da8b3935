"""Plain PyTorch versions of every kernel (the correctness contract).
They mirror ``repro.kernels.ref`` and are what the kernel wrappers run
for tensors on the CPU; on the card the CUDA kernels are held against
them."""
from __future__ import annotations

import math

import torch

#: masked attention logits: -1e30, not -inf, as in the reference
MASK_VALUE = -1e30
#: same-width integer views for the bitwise block compare
_INTS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def ckpt_pack_plain(x2d, *, out_dtype=torch.bfloat16, scale=1.0):
    """(packed (n, block) out_dtype, amax (n,) f32) of ``f32(x) * scale``."""
    xf = x2d.to(torch.float32) * scale
    return xf.to(out_dtype), xf.abs().amax(dim=1)


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


def flash_attention_plain(q, k, v, *, causal=True, window=None, cap=None):
    """q (B, H, Lq, hd); k, v (B, KV, Lk, hd) -> (B, H, Lq, hd) in q's
    dtype, with the Pallas kernel's arithmetic: f32 scores scaled by
    1/sqrt(hd), masked logits at -1e30, p kept in f32 against an f32 v.
    A row with no valid key averages v over the Lk keys, as
    ``repro.kernels.ref.flash_attention_ref`` does."""
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
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)


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
