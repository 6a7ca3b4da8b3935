"""flash_attention — blocked attention with an online softmax for Hopper
(CUDA C++, sm_90a, ``csrc/flash_attention.cu``), with a gradient.

The forward replaces ``repro.kernels.flash_attention.flash_attention``
(TPU Pallas); head dims 64, 80, 96 and 128, every one the repo's configs
send to the kernel, the same for q, k and v; and, in bfloat16 only,
MLA's 192 for q and k with 128 for v (DeepSeek-V2's nope 128 + rope 64
and v_head_dim 128; ``SHAPES``). Both bodies run on the tensor cores
(``mma.sync``):
bfloat16 inputs with P rounded to bfloat16 for P·V (within the bfloat16
tolerance 2e-2); float32 inputs with every product split into three TF32
products (hi·hi + hi·lo + lo·hi, about 2^-21 relative each, for the
float32 tolerance 2e-5). At the path's f32 shape (4, 32, 512, 64) causal
the f32 body's bound is 0.0261 ms of 3×TF32 products (bytes: 0.0200 ms).

The backward replaces no TPU kernel (the reference's Pallas kernel is
forward-only and its training attention is left to XLA): two bfloat16
kernels in the same source, dQ then dK/dV, that recompute P from the
forward's log-sum-exp and never write an (L × L) tensor. They take what
the training path sends: bfloat16, no window, no soft-cap. The source
says what bounds each kernel and how its design follows.

``flash_attention`` carries a gradient through ``_Attention`` wherever
autograd asks for one; its backward raises for a window, a soft-cap or
float32 inputs. The wrapper runs the plain PyTorch versions
(``repro_torch.kernels.ref``) for CPU tensors only; for a CUDA tensor it
launches the kernels or raises, and counts the forward's launches in
``flash_attention.launches`` and the backward's (one a call, for its two
kernels) in ``flash_attention.backward_launches``. ``kernel_takes`` is
the model's test of whether a call goes here (``transformer._block``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (flash_attention_bwd_plain,
                                     flash_attention_plain)

_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 80, 96, 128)
#: (q and k head dim, v head dim) of the bodies: every head dim of
#: ``HEAD_DIMS`` for all three, and MLA's pair in bfloat16 only
MLA_DIMS = ((192, 128),)
SHAPES = tuple((hd, hd) for hd in HEAD_DIMS) + MLA_DIMS
#: the kernels' q tile: the log-sum-exp's rows are padded to a multiple
_BQ = 64


def _bind(lib):
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)] \
        + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_float,
                                  ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bwd = lib.flash_attention_bwd_launch
    bwd.argtypes = [ctypes.c_void_p] * 10 \
        + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 8 \
        + [ctypes.c_float, ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.flash_attention_smem_bytes.restype = ctypes.c_longlong
    lib.flash_attention_bwd_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.flash_attention_bwd_smem_bytes.restype = ctypes.c_longlong


def smem_bytes(hd: int, dtype, hd_v=None) -> int:
    """Dynamic shared memory per block of the body that takes (hd, hd_v
    (default hd), dtype) (builds the kernel on first use)."""
    return build.load("flash_attention", _bind).flash_attention_smem_bytes(
        hd, hd if hd_v is None else hd_v, _CODES[dtype])


def bwd_smem_bytes(hd: int, hd_v=None) -> int:
    """Dynamic shared memory per block of either backward kernel at (hd,
    hd_v (default hd))."""
    return build.load("flash_attention",
                      _bind).flash_attention_bwd_smem_bytes(
        hd, hd if hd_v is None else hd_v)


def kernel_takes(q, window=None, cap=None, hd_v=None) -> bool:
    """Whether the forward and backward kernels take a causal attention
    over ``q`` (any layout of (.., hd)) and a v of head dim ``hd_v``
    (default hd): a CUDA tensor in bfloat16, (hd, hd_v) in ``SHAPES``, no
    window and no soft-cap."""
    hd = q.shape[-1]
    return (q.is_cuda and q.dtype == torch.bfloat16
            and (hd, hd if hd_v is None else hd_v) in SHAPES
            and window is None and cap is None)


def _rows(t):
    """``t`` with a contiguous last dimension and 16-byte aligned rows
    (the kernel walks the other three by stride and copies rows in 16-byte
    pieces: the model's (B, L, H, hd) tensors swapped to (B, H, L, hd) are
    read in place, without a copy); anything else is copied once."""
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
            s * t.element_size() % 16 == 0 for s in t.stride()[:3]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _like(q, hd_v):
    """An output of q's shape and layout with head dim ``hd_v``: the
    model's (B, L, H, ·) swapped to (B, H, L, ·) where q is such a view,
    else contiguous (B, H, L, ·)."""
    B, H, Lq, _ = q.shape
    if q.stride(1) < q.stride(2):
        return q.new_empty((B, Lq, H, hd_v)).transpose(1, 2)
    return q.new_empty((B, H, Lq, hd_v))


def _strides(*ts):
    return (ctypes.c_longlong * (3 * len(ts)))(*(
        s for t in ts for s in t.stride()[:3]))


def _check(q, k, v, window, cap):
    B, H, Lq, hd = q.shape
    KV, Lk = k.shape[1], k.shape[2]
    if q.dtype not in _CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; the kernel takes float32 or bfloat16, "
                        f"the same for q, k and v")
    shapes = SHAPES if q.dtype == torch.bfloat16 else SHAPES[:len(HEAD_DIMS)]
    if (hd, v.shape[-1]) not in shapes or k.shape[-1] != hd:
        raise ValueError(f"flash_attention: head_dim {hd} (k {k.shape[-1]}, "
                         f"v {v.shape[-1]}); the kernel takes (q and k, v) "
                         f"{shapes} in {q.dtype}")
    if (k.shape[0] != B or v.shape[:3] != k.shape[:3] or KV == 0
            or H % KV):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if Lq == 0 or Lk == 0 or B > 65535 or H > 65535:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}: empty or too large a grid")
    if (window is not None and window < 1) or (cap is not None and cap <= 0):
        raise ValueError(f"flash_attention: window {window}, cap {cap}: "
                         f"the kernel takes a window >= 1 and a cap > 0")


def _forward(q, k, v, causal, window, cap, want_lse):
    """(out, lse): the forward kernel on CUDA tensors, ``lse`` (B, H, Lq
    padded to a multiple of 64) f32 base-2 only if ``want_lse``; the plain
    version on the CPU (``lse`` (B, H, Lq))."""
    if q.device.type == "cpu":
        out = flash_attention_plain(q, k, v, causal=causal, window=window,
                                    cap=cap, lse=want_lse)
        return out if want_lse else (out, None)
    B, H, Lq, hd = q.shape
    hd_v = v.shape[-1]
    build.on_cuda("flash_attention", q, k, v)
    q, k, v = _rows(q), _rows(k), _rows(v)
    out = torch.empty_like(q) if hd_v == hd else _like(q, hd_v)
    lse = (torch.empty((B, H, -(-Lq // _BQ) * _BQ), dtype=torch.float32,
                       device=q.device) if want_lse else None)
    lib = build.load("flash_attention", _bind)
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _strides(q, k, v, out), B, H, k.shape[1], Lq, k.shape[2], hd,
            hd_v, _CODES[q.dtype], int(causal),
            -1 if window is None else int(window),
            0.0 if cap is None else float(cap), 1.0 / math.sqrt(hd),
            None if lse is None else lse.data_ptr(), build.stream_of(q))
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {rc}")
    flash_attention.launches += 1
    return out, lse


def _backward(q, k, v, out, lse, dout, causal):
    """(dq, dk, dv) in q's dtype: the backward kernels on CUDA tensors,
    the plain version on the CPU."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                         causal=causal)
    B, H, Lq, hd = q.shape
    build.on_cuda("flash_attention", q, k, v, out, lse, dout)
    dout = _rows(dout)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty_like(lse)
    lib = build.load("flash_attention", _bind)
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            _strides(q, k, v, out, dout, dq, dk, dv), B, H, k.shape[1], Lq,
            k.shape[2], hd, v.shape[-1], int(causal), 1.0 / math.sqrt(hd),
            build.stream_of(q))
    if rc != 0:
        raise RuntimeError(f"flash_attention backward launch failed: "
                           f"cudaError {rc}")
    flash_attention.backward_launches += 1
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """The forward kernel with the log-sum-exp; saves q, k, v, the output
    and the log-sum-exp (nothing of size L × L) for the backward
    kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, cap):
        q, k, v = _rows(q), _rows(k), _rows(v)    # as the kernels read them
        ctx.refused = (
            None if q.dtype == torch.bfloat16 and window is None
            and cap is None else
            f"flash_attention: no backward for {q.dtype} inputs, window "
            f"{window}, cap {cap}; the backward kernels take bfloat16 "
            f"without a window or a soft-cap")
        out, lse = _forward(q, k, v, causal, window, cap,
                            want_lse=ctx.refused is None)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        if ctx.refused is not None:
            raise RuntimeError(ctx.refused)
        q, k, v, out, lse = ctx.saved_tensors
        return (*_backward(q, k, v, out, lse, dout, ctx.causal), None, None,
                None)


def flash_attention(q, k, v, *, causal=True, window=None, cap=None):
    """q (B, H, Lq, hd); k (B, KV, Lk, hd); v (B, KV, Lk, hd_v) -> (B, H,
    Lq, hd_v) in q's dtype, with the layout of q (so the caller's swap
    back is free).

    The reference's ``block_q``/``block_k`` (its Pallas tiling) are not
    taken: the CUDA kernel always tiles 64 x 64. Takes float32 and
    bfloat16 with hd = hd_v of 64, 80, 96 or 128, and bfloat16 with hd 192
    and hd_v 128 (MLA); raises on anything else. Scores are scaled by
    1 / sqrt(hd). Under autograd the output carries a gradient
    (``_Attention``)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     cap=cap)
    _check(q, k, v, window, cap)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return _Attention.apply(q, k, v, causal, window, cap)
    return _forward(q, k, v, causal, window, cap, want_lse=False)[0]


flash_attention.launches = 0
flash_attention.backward_launches = 0
