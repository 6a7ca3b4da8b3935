"""Quantized checkpointing (beyond-paper extension; a copy of
``repro.core.quant`` on torch tensors).

Check-N-Run [NSDI'22] shrinks checkpoints via quantization; the paper
contrasts FastPersist as lossless. We provide BOTH: an optional int8
per-block quantization of the checkpoint's float records.

Stream records: ``<name>#q8`` (dtype ``int8|<orig>``, the tensor's
shape) followed by ``<name>#scale`` (float32, one per block) for every
float32/bfloat16/float16 tensor of at least ``BLOCK`` elements; the
rest pass through. bf16 goes through ``torch.bfloat16`` (no ml_dtypes).
The arithmetic is the reference's: a block's scale is its f32 abs-max
over 127 (1 for an all-zero or NaN block), and its int8 values are the
f32 division by the scale, rounded half to even and clipped to ±127.

Two routes give the same bytes. A save quantizes its leaves before the
snapshot (:func:`quantize_leaves`): on the card that is the
``ckpt_quant`` CUDA kernel, so only the int8 values and the scales leave
the device; a host tensor takes the kernel's plain version.
:func:`quantize_stream` quantizes a serialized stream on the host, as
the reference does, ``_ROWS`` blocks per pass; its scales may come from
the ``ckpt_pack_blocks`` kernel's amax (:func:`device_block_amax`, the
reference's device half of the transform). A restore onto the card
dequantizes there (:func:`dequantize_named` with ``device``).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.serializer import (Manifest, TensorRecord, dtype_name,
                                         store_dtype)

BLOCK = 4096
_QUANT_SUFFIX = "#q8"
_SCALE_SUFFIX = "#scale"
_QUANTIZABLE = ("float32", "bfloat16", "float16")
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
#: blocks per host pass (bounds the f32 temporaries to 4 MiB)
_ROWS = 256


def quantizable(dtype: str, numel: int) -> bool:
    """The reference's eligibility rule: a float dtype and at least one
    whole block of elements."""
    return dtype in _QUANTIZABLE and numel >= BLOCK


def _host_flat(x) -> torch.Tensor:
    """Flat CPU tensor over ``x`` (numpy array or tensor; device tensors
    are copied to the host first), zero-copy where it can be."""
    if isinstance(x, np.ndarray):
        if not (x.flags.writeable and x.flags.aligned):
            x = x.copy()
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.detach().reshape(-1).cpu()


def _passes(n: int):
    """``(first block, blocks, element lo, element hi)`` of each host
    pass over ``n`` elements; only the last block may be short."""
    nb = -(-n // BLOCK)
    for b in range(0, nb, _ROWS):
        k = min(_ROWS, nb - b)
        yield b, k, b * BLOCK, min((b + k) * BLOCK, n)


def _f32_rows(flat: torch.Tensor, lo: int, hi: int, k: int) -> torch.Tensor:
    """Elements [lo, hi) of ``flat`` in float32 as ``(k, BLOCK)`` rows,
    zero-padded (new storage when ``flat`` is not float32 or a pad is
    needed, else a view: callers never write to it)."""
    x = flat[lo:hi].float()
    pad = k * BLOCK - (hi - lo)
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    return x.view(k, BLOCK)


def block_amax(arr) -> np.ndarray:
    """HOST half of the blockwise scale: per-block absolute maxima of
    the f32-cast flattened array (zero-padded to a BLOCK multiple). The
    ``ckpt_pack_blocks`` kernel's amax output is the DEVICE half — same
    padding rule, same f32 values, so the two agree bitwise on
    identical inputs; a NaN propagates on both."""
    flat = _host_flat(arr)
    out = np.empty(-(-flat.numel() // BLOCK), np.float32)
    for b, k, lo, hi in _passes(flat.numel()):
        out[b:b + k] = _f32_rows(flat, lo, hi, k).abs().amax(dim=1).numpy()
    return out


def launch_block_amax(x: torch.Tensor) -> torch.Tensor:
    """Per-block amax of ``x`` computed BY the ``ckpt_pack_blocks``
    kernel (the reference's device half of the transform), enqueued on
    the current stream without synchronising; the result stays on
    ``x``'s device. A CPU tensor runs the kernel's plain version; any
    other device launches the kernel or raises. The packed bf16 output
    is discarded."""
    from repro_torch.kernels import ops
    _packed, amax = ops.ckpt_pack(x, out_dtype=torch.bfloat16, block=BLOCK)
    return amax


def device_block_amax(x) -> np.ndarray:
    """:func:`launch_block_amax`, brought to the host: feed it to
    ``_blockwise(arr, amax=...)`` / ``quantize_stream(amax_fn=...)`` to
    skip the host reduction when the tensor is on the card."""
    return launch_block_amax(x).cpu().numpy()


def quantize_leaves(leaves) -> Tuple[list, Dict[str, str], float]:
    """The records of a quantized save, from the state's ``[(name,
    leaf), ...]``, in :func:`quantize_stream`'s order: each quantizable
    leaf becomes ``(name#q8, int8 values in the leaf's shape)`` and
    ``(name#scale, f32 per block)``, each other leaf passes through.
    Quantization is ``ops.ckpt_quant``: the CUDA kernel for a leaf on the
    card, enqueued on the current stream without synchronising (the
    outputs are new storage, so they hold the values of the moment of
    the launch); its plain version on the host. Returns (records, the
    manifest dtype of each ``#q8`` record — ``int8|<orig>``, which is
    not its tensor's —, seconds spent quantizing on the host)."""
    from repro_torch.kernels import ops
    out, dtypes, host_s = [], {}, 0.0
    for name, leaf in leaves:
        dt = dtype_name(leaf)
        shape = tuple(leaf.shape)
        if not quantizable(dt, int(np.prod(shape, dtype=np.int64))):
            out.append((name, leaf))
            continue
        host = not (isinstance(leaf, torch.Tensor) and leaf.is_cuda)
        t0 = time.perf_counter()
        q, scale = ops.ckpt_quant(_host_flat(leaf) if host else leaf,
                                  block=BLOCK)
        if host:
            host_s += time.perf_counter() - t0
        out += [(name + _QUANT_SUFFIX, q.view(shape)),
                (name + _SCALE_SUFFIX, scale)]
        dtypes[name + _QUANT_SUFFIX] = f"int8|{dt}"
    return out, dtypes, host_s


def amax_to_scale(amax: np.ndarray) -> np.ndarray:
    """Blockwise scale from per-block amax (all-zero blocks get 1.0 so
    dequantization never divides by / multiplies with 0; so does a NaN
    block, since NaN > 0 is false)."""
    amax = np.asarray(amax, np.float32)
    return np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)


def _blockwise(arr, amax: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """``(int8 values, f32 per-block scales)`` of ``arr`` (numpy array
    or tensor of any float dtype). ``amax`` (per block) skips the host
    reduction. The int8 value of a NaN element is undefined, as in the
    reference."""
    flat = _host_flat(arr)
    n = flat.numel()
    nb = -(-n // BLOCK)
    if amax is not None:
        amax = np.asarray(amax, np.float32).reshape(-1)
        if amax.size != nb:
            raise ValueError(f"amax has {amax.size} blocks; {n} elements "
                             f"make {nb}")
    from repro_torch.kernels.ref import ckpt_quant_plain
    scale = torch.empty(nb, dtype=torch.float32)
    q = torch.empty(nb * BLOCK, dtype=torch.int8)
    for b, k, lo, hi in _passes(n):
        rows, scale[b:b + k] = ckpt_quant_plain(
            _f32_rows(flat, lo, hi, k),
            amax=None if amax is None else torch.from_numpy(amax[b:b + k]))
        q[b * BLOCK:(b + k) * BLOCK] = rows.view(-1)
    return q[:n].numpy(), scale.numpy()


def _deblock_whole(q: torch.Tensor, scale: torch.Tensor,
                   dtype: str) -> torch.Tensor:
    """:func:`_deblock` in one pass over flat tensors on one device (the
    restore onto the card): the same f32 product ``f32(q) · scale``,
    rounded once, straight into the ``dtype`` output."""
    n = q.numel()
    out = torch.empty(n, dtype=_TORCH[dtype], device=q.device)
    whole = n // BLOCK * BLOCK
    if whole:
        torch.mul(q[:whole].view(-1, BLOCK), scale[:whole // BLOCK, None],
                  out=out[:whole].view(-1, BLOCK))
    if whole < n:
        torch.mul(q[whole:], scale[whole // BLOCK], out=out[whole:])
    return out


def _deblock(q, scale, dtype: str, device=None) -> torch.Tensor:
    """Inverse of :func:`_blockwise`: the flat ``dtype`` tensor of
    ``int8 · scale`` (f32 product, one rounding to ``dtype``). With a
    ``device`` other than the CPU the int8 values and scales are copied
    there and the product runs there; the result stays there."""
    qt, st = _host_flat(q), _host_flat(scale)
    if device is not None and torch.device(device).type != "cpu":
        return _deblock_whole(qt.to(device), st.to(device), dtype)
    n = qt.numel()
    out = torch.empty(n, dtype=_TORCH[dtype])
    for b, k, lo, hi in _passes(n):
        prod = _f32_rows(qt, lo, hi, k) * st[b:b + k, None]
        out[lo:hi] = prod.view(-1)[:hi - lo]
    return out


def _stream_values(buf: np.ndarray, dtype: str) -> torch.Tensor:
    """An on-stream buffer (typed, or the serializer's flat bytes) as a
    flat tensor of its record dtype (bf16 from its uint16 bits)."""
    raw = np.ascontiguousarray(buf).reshape(-1).view(np.uint8)
    if dtype == "bfloat16":
        return _host_flat(raw.view(np.int16)).view(torch.bfloat16)
    return _host_flat(raw.view(store_dtype(dtype)))


def quantize_stream(manifest: Manifest, buffers: List[np.ndarray],
                    amax_fn=None) -> Tuple[Manifest, List[np.ndarray]]:
    """Rewrite (manifest, buffers) with int8+scale record pairs for every
    quantizable tensor. Small/int tensors pass through unchanged.

    ``amax_fn(values) -> per-block amax`` plugs in a reduction per record
    (:func:`device_block_amax`); without it, or for a record it returns
    None for, the host reduction runs."""
    records, out = [], []
    offset = 0

    def push(name, arr, dtype, shape):
        nonlocal offset
        records.append(TensorRecord(name, dtype, tuple(shape), offset,
                                    arr.nbytes))
        out.append(arr)
        offset += arr.nbytes

    for rec, buf in zip(manifest.records, buffers):
        if quantizable(rec.dtype, int(np.prod(rec.shape, dtype=np.int64))):
            values = _stream_values(buf, rec.dtype)
            q, scale = _blockwise(
                values, amax=amax_fn(values) if amax_fn is not None else None)
            push(rec.name + _QUANT_SUFFIX, q, f"int8|{rec.dtype}",
                 rec.shape)
            push(rec.name + _SCALE_SUFFIX, scale, "float32", scale.shape)
        else:
            push(rec.name, buf, rec.dtype, rec.shape)
    m = Manifest(records, offset, dict(manifest.extras), manifest.treedef)
    m.extras["quantized"] = True
    return m, out


def dequantize_named(named: dict, manifest: Manifest, device=None) -> dict:
    """{name: tensor} from deserialize() -> original-dtype tensors. With
    ``device`` (not the CPU) each quantized record is dequantized there;
    the records that were not quantized stay as they were given."""
    dtypes = {r.name: r.dtype for r in manifest.records}
    shapes = {r.name: r.shape for r in manifest.records}
    out = {}
    for name, arr in named.items():
        if name.endswith(_SCALE_SUFFIX):
            continue
        if name.endswith(_QUANT_SUFFIX):
            base = name[:-len(_QUANT_SUFFIX)]
            orig = dtypes[name].split("|")[1]
            scale = named[base + _SCALE_SUFFIX]
            out[base] = _deblock(arr, scale, orig,
                                 device).reshape(shapes[name])
        else:
            out[name] = arr
    return out
