"""flash_attention — blocked attention with an online softmax for Hopper
(CUDA C++, sm_90a, ``csrc/flash_attention.cu``).

Replaces ``repro.kernels.flash_attention.flash_attention`` (TPU Pallas).
Forward only, as the reference; head dims 64, 80, 96 and 128, every one
the repo's configs send to the kernel. Both bodies run on the tensor
cores (``mma.sync``): bfloat16 inputs with P rounded to bfloat16 for P·V
(within the bfloat16 tolerance 2e-2); float32 inputs with every product
split into three TF32 products (hi·hi + hi·lo + lo·hi, about 2^-21
relative each, for the float32 tolerance 2e-5). At the path's f32 shape
(4, 32, 512, 64) causal the f32 body's bound is 0.0261 ms of 3×TF32
products (bytes: 0.0200 ms). The source says what bounds each body and
how its design follows. The wrapper runs the plain PyTorch version
(``repro_torch.kernels.ref.flash_attention_plain``) for CPU tensors only;
for a CUDA tensor it launches the kernel or raises, and counts the
launch in ``flash_attention.launches``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_plain

_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 80, 96, 128)


def _bind(lib):
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)] \
        + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_float,
                                 ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.flash_attention_smem_bytes.restype = ctypes.c_longlong


def smem_bytes(hd: int, dtype) -> int:
    """Dynamic shared memory per block of the body that takes (hd, dtype)
    (builds the kernel on first use)."""
    return build.load("flash_attention", _bind).flash_attention_smem_bytes(
        hd, _CODES[dtype])


def _rows(t):
    """``t`` with a contiguous last dimension and 16-byte aligned rows
    (the kernel walks the other three by stride and copies rows in 16-byte
    pieces: the model's (B, L, H, hd) tensors swapped to (B, H, L, hd) are
    read in place, without a copy); anything else is copied once."""
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
            s * t.element_size() % 16 == 0 for s in t.stride()[:3]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def flash_attention(q, k, v, *, causal=True, window=None, cap=None):
    """q (B, H, Lq, hd); k, v (B, KV, Lk, hd) -> (B, H, Lq, hd) in q's
    dtype, with the strides of q (so the caller's swap back is free).

    The reference's ``block_q``/``block_k`` (its Pallas tiling) are not
    taken: the CUDA kernel always tiles 64 x 64. Takes float32 and
    bfloat16, head_dim 64, 80, 96 or 128; raises on anything else."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     cap=cap)
    B, H, Lq, hd = q.shape
    KV, Lk = k.shape[1], k.shape[2]
    if q.dtype not in _CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; the kernel takes float32 or bfloat16, "
                        f"the same for q, k and v")
    if hd not in HEAD_DIMS or k.shape[-1] != hd or v.shape[-1] != hd:
        raise ValueError(f"flash_attention: head_dim {hd} (k {k.shape[-1]}, "
                         f"v {v.shape[-1]}); the kernel takes {HEAD_DIMS}")
    if k.shape[0] != B or v.shape != k.shape or KV == 0 or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if Lq == 0 or Lk == 0 or B > 65535 or H > 65535:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}: empty or too large a grid")
    if (window is not None and window < 1) or (cap is not None and cap <= 0):
        raise ValueError(f"flash_attention: window {window}, cap {cap}: "
                         f"the kernel takes a window >= 1 and a cap > 0")
    build.on_cuda("flash_attention", q, k, v)
    q, k, v = _rows(q), _rows(k), _rows(v)
    out = torch.empty_like(q)
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, out) for s in t.stride()[:3]))
    lib = build.load("flash_attention", _bind)
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            strides, B, H, KV, Lq, Lk, hd, _CODES[q.dtype], int(causal),
            -1 if window is None else int(window),
            0.0 if cap is None else float(cap), 1.0 / math.sqrt(hd),
            build.stream_of(q))
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
