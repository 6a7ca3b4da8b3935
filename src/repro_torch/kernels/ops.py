"""Public wrappers around the kernels (the counterpart of
``repro.kernels.ops``). The ckpt_pack ones flatten + zero-pad any tensor
into ``(n_blocks, block)`` rows, then pack. ``flash_attention`` and
``ssd_intra_chunk`` are the kernel wrappers themselves, with the
reference's signatures less ``flash_attention``'s ``block_q``/``block_k``
(the CUDA kernel's tiling is fixed); their launch counts are
``ops.flash_attention.launches`` and ``ops.ssd_intra_chunk.launches``."""
from __future__ import annotations

import torch

from repro_torch.kernels import ckpt_pack as _cp
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_intra_chunk

__all__ = ["ckpt_pack", "ckpt_pack_dirty", "flash_attention", "pack_blocks",
           "ssd_intra_chunk"]


def _to_blocks(flat, block):
    """(n_blocks, block) rows of ``flat``, zero-padded; a view when no
    pad is needed."""
    pad = (-flat.shape[0]) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, block)


def ckpt_pack(x, *, out_dtype=torch.bfloat16, scale=1.0,
              block=_cp.DEFAULT_BLOCK):
    """Flatten+cast+amax any-shape tensor into checkpoint blocks.

    Returns (packed flat tensor of x.numel() elements, per-block amax)."""
    flat = x.detach().reshape(-1)
    n = flat.shape[0]
    packed, amax = _cp.ckpt_pack_blocks(_to_blocks(flat, block),
                                        out_dtype=out_dtype, scale=scale)
    return packed.reshape(-1)[:n], amax


def pack_blocks(x, *, block=_cp.DEFAULT_BLOCK):
    """Layout-pack only: flatten + zero-pad to (n_blocks, block), keeping
    x's dtype and bits. This is the baseline image ``ckpt_pack_dirty``
    compares against; the pad rule matches, so pad blocks never read as
    dirty. Always NEW storage: a reshape of a contiguous tensor is a
    view, and a baseline that aliased a parameter the optimizer updates
    in place would read as clean when it is dirty."""
    flat = x.detach().reshape(-1)
    n = flat.shape[0]
    out = torch.empty(n + (-n) % block, dtype=flat.dtype, device=flat.device)
    out[:n].copy_(flat)
    out[n:].zero_()
    return out.reshape(-1, block)


def ckpt_pack_dirty(x, prev2d, *, out_dtype=None, scale=1.0,
                    block=_cp.DEFAULT_BLOCK):
    """Pack + per-block change mask vs a device-resident previous image.

    prev2d is the (n_blocks, block) packed image of the LAST snapshot (a
    prior ``packed`` output, or ``pack_blocks`` of the old value).
    Returns (packed (n_blocks, block), amax (n_blocks,), mask (n_blocks,)
    int32). With out_dtype=None (same dtype, scale 1) the pack is
    bit-preserving, so mask==0 blocks are byte-identical to the previous
    checkpoint stream — the contract the device-dirty snapshot relies on
    (DESIGN.md §10)."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    x2d = _to_blocks(x.detach().reshape(-1), block)
    return _cp.ckpt_pack_dirty_blocks(x2d, prev2d, out_dtype=out_dtype,
                                      scale=scale)
