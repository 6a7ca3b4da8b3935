"""Plain PyTorch versions of the ckpt_pack kernels (the correctness
contract). They mirror ``repro.kernels.ref`` and are what the kernel
wrappers run for tensors on the CPU; on the card the CUDA kernels are
held against them."""
from __future__ import annotations

import torch

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
