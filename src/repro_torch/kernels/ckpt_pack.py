"""ckpt_pack — checkpoint pack kernels for Hopper (CUDA C++, sm_90a).

Replaces ``repro.kernels.ckpt_pack`` (TPU Pallas): ``ckpt_pack_blocks``
and ``ckpt_pack_dirty_blocks`` both launch the one template in
``csrc/ckpt_pack.cu``. ``ckpt_quant_blocks`` is ``ckpt_pack_blocks``'
quantize mode, a sibling kernel in the same source: the block amax, then
the int8 quantizer of ``core.quant`` on the card (int8 values and f32
scales, no pack). The work is bound by bytes (the dirty pack moves x,
prev and packed once each); the source says how the design follows.

The library is built with ``nvcc`` from the package's own source into
``build/kernels/`` at the repository root on first use and loaded with
``ctypes`` (``repro_torch.kernels.build``). Each wrapper runs its plain
PyTorch version (``repro_torch.kernels.ref``) for CPU tensors only; for
a CUDA tensor it launches the kernel or raises. Each wrapper counts its launches in a
plain integer attribute, ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (ckpt_pack_dirty_plain, ckpt_pack_plain,
                                     ckpt_quant_plain)

DEFAULT_BLOCK = 8 * 1024
#: the quantize mode holds a row in registers: at most this many elements
QUANT_MAX_BLOCK = 4096
#: rows per pass of the quantize mode's plain version on the host
PLAIN_ROWS = 256

_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _bind(lib):
    fn = lib.ckpt_pack_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.ckpt_quant_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int


def to_blocks(flat, block):
    """(n_blocks, block) rows of ``flat``, zero-padded; a view when no
    pad is needed."""
    pad = (-flat.shape[0]) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, block)


def _operand(t: torch.Tensor, what: str) -> torch.Tensor:
    if t.dtype not in _CODES:
        raise TypeError(f"ckpt_pack: {what} dtype {t.dtype} not supported "
                        f"(float32, bfloat16, float16)")
    t = t.contiguous()
    if t.data_ptr() % 16:           # 16-byte vector loads
        t = t.clone()
    return t


def _launch(x2d, prev2d, out_dtype, scale, identity: bool):
    """Allocate the outputs and launch the kernel on the current stream
    (no synchronisation). Returns (packed, amax, mask-or-None)."""
    build.on_cuda("ckpt_pack", x2d)
    n, block = x2d.shape
    if block % 8:
        raise ValueError(f"ckpt_pack: block {block} is not a multiple of 8 "
                         f"elements (16-byte vectors)")
    if out_dtype not in _CODES:
        raise TypeError(f"ckpt_pack: out dtype {out_dtype} not supported")
    x2d = _operand(x2d, "input")
    dev = x2d.device
    y = torch.empty((n, block), dtype=out_dtype, device=dev)
    amax = torch.empty((n,), dtype=torch.float32, device=dev)
    mask = None
    if prev2d is not None:
        prev2d = _operand(prev2d, "prev")
        if prev2d.dtype != out_dtype or prev2d.device != dev:
            raise ValueError(f"ckpt_pack: prev2d is {prev2d.dtype} on "
                             f"{prev2d.device}, expected {out_dtype} on "
                             f"{dev}")
        mask = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return y, amax, mask
    lib = build.load("ckpt_pack", _bind)
    with torch.cuda.device(dev):
        rc = lib.ckpt_pack_launch(
            x2d.data_ptr(), prev2d.data_ptr() if mask is not None else None,
            y.data_ptr(), amax.data_ptr(),
            mask.data_ptr() if mask is not None else None,
            n, block, _CODES[x2d.dtype], _CODES[out_dtype], int(identity),
            int(mask is not None), float(scale),
            build.stream_of(x2d))
    if rc != 0:
        raise RuntimeError(f"ckpt_pack kernel launch failed: cudaError {rc}")
    return y, amax, mask


def ckpt_pack_blocks(x2d, *, out_dtype=torch.bfloat16, scale=1.0):
    """x2d (n_blocks, BLOCK) -> (packed (n_blocks, BLOCK) out_dtype,
    amax (n_blocks,) f32) of ``f32(x) * scale``."""
    if x2d.device.type == "cpu":
        return ckpt_pack_plain(x2d, out_dtype=out_dtype, scale=scale)
    packed, amax, _ = _launch(x2d, None, out_dtype, scale, identity=False)
    ckpt_pack_blocks.launches += int(x2d.shape[0] > 0)
    return packed, amax


def ckpt_pack_dirty_blocks(x2d, prev2d, *, out_dtype=torch.bfloat16,
                           scale=1.0):
    """Pack + per-block change mask against a device-resident image.

    prev2d (n_blocks, BLOCK) in ``out_dtype`` is the packed image of the
    previous snapshot. Returns (packed, amax (n_blocks,) f32, mask
    (n_blocks,) int32) with mask[i] = 1 iff block i's packed bits differ
    from prev2d's. ``packed`` is always new storage."""
    if prev2d.shape != x2d.shape:
        raise ValueError(f"prev2d shape {tuple(prev2d.shape)} != "
                         f"{tuple(x2d.shape)}")
    if x2d.device.type == "cpu":
        return ckpt_pack_dirty_plain(x2d, prev2d, out_dtype=out_dtype,
                                     scale=scale)
    identity = out_dtype == x2d.dtype and float(scale) == 1.0
    out = _launch(x2d, prev2d, out_dtype, scale, identity)
    ckpt_pack_dirty_blocks.launches += int(x2d.shape[0] > 0)
    return out


def _quant_plain_passes(flat, block):
    """:func:`ckpt_quant_plain` over a host tensor, ``PLAIN_ROWS`` rows
    per pass, so its f32 temporaries stay near 4 MiB whatever the size
    of the leaf; only the last pass is padded."""
    n = flat.shape[0]
    nb = -(-n // block)
    q = torch.empty(nb * block, dtype=torch.int8)
    scale = torch.empty(nb, dtype=torch.float32)
    for b in range(0, nb, PLAIN_ROWS):
        k = min(PLAIN_ROWS, nb - b)
        lo = b * block
        rows, scale[b:b + k] = ckpt_quant_plain(
            to_blocks(flat[lo:min(lo + k * block, n)], block))
        q[lo:lo + k * block] = rows.reshape(-1)
    return q[:n], scale


def ckpt_quant_blocks(flat, *, block=QUANT_MAX_BLOCK):
    """Blockwise int8 quantization of a flat f32/bf16/f16 tensor of n
    elements, in rows of ``block`` (the last one zero-padded, as
    :func:`to_blocks` pads): returns (q (n,) int8, scale (n_blocks,)
    f32), bit-equal to :func:`ckpt_quant_plain` on those rows. On the
    card the kernel reads the tail itself: no padded copy is made."""
    if flat.dim() != 1:
        raise ValueError(f"ckpt_quant: expected a flat tensor, got shape "
                         f"{tuple(flat.shape)}")
    n = flat.shape[0]
    if flat.device.type == "cpu":
        return _quant_plain_passes(flat, block)
    build.on_cuda("ckpt_quant", flat)
    if block % 8 or not 0 < block <= QUANT_MAX_BLOCK:
        raise ValueError(f"ckpt_quant: block {block} must be a multiple of "
                         f"8 elements, at most {QUANT_MAX_BLOCK}")
    flat = _operand(flat, "input")
    dev = flat.device
    q = torch.empty((n,), dtype=torch.int8, device=dev)
    scale = torch.empty((-(-n // block),), dtype=torch.float32, device=dev)
    if n == 0:
        return q, scale
    lib = build.load("ckpt_pack", _bind)
    with torch.cuda.device(dev):
        rc = lib.ckpt_quant_launch(flat.data_ptr(), q.data_ptr(),
                                   scale.data_ptr(), n, block,
                                   _CODES[flat.dtype], build.stream_of(flat))
    if rc != 0:
        raise RuntimeError(f"ckpt_quant kernel launch failed: cudaError {rc}")
    ckpt_quant_blocks.launches += 1
    return q, scale


ckpt_pack_blocks.launches = 0
ckpt_pack_dirty_blocks.launches = 0
ckpt_quant_blocks.launches = 0
