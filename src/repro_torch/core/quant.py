"""Quantized checkpointing (beyond-paper extension; a copy of
``repro.core.quant`` on torch tensors).

Check-N-Run [NSDI'22] shrinks checkpoints via quantization; the paper
contrasts FastPersist as lossless. We provide BOTH: an optional int8
per-block quantization pass over the serialized stream. The scale of a
block comes from its f32 abs-max: for a tensor on the card that
reduction is the ``ckpt_pack_blocks`` CUDA kernel's amax output
(:func:`device_block_amax`), for a host buffer it is :func:`block_amax`.
Both use the same zero padding and the same f32 values, so they agree
bit for bit and the bytes on disk do not depend on which one ran; they
are the reference's bytes.

Stream records: ``<name>#q8`` (dtype ``int8|<orig>``, the tensor's
shape) followed by ``<name>#scale`` (float32, one per block) for every
float32/bfloat16/float16 tensor of at least ``BLOCK`` elements; the
rest pass through. bf16 goes through ``torch.bfloat16`` (no ml_dtypes).
The quantizer itself runs on the host, ``_ROWS`` blocks per pass, with
the reference's arithmetic: f32 division by the scale, round half to
even, clip to ±127.
"""
from __future__ import annotations

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
    kernel (the device-side half this module's docstring promises),
    enqueued on the current stream without synchronising; the result
    stays on ``x``'s device. A CPU tensor runs the kernel's plain
    version; any other device launches the kernel or raises. The
    packed bf16 output is discarded: for float32 records it moves 2
    bytes per element where an identity pack would move 4."""
    from repro_torch.kernels import ops
    _packed, amax = ops.ckpt_pack(x, out_dtype=torch.bfloat16, block=BLOCK)
    return amax


def device_block_amax(x) -> np.ndarray:
    """:func:`launch_block_amax`, brought to the host: feed it to
    ``_blockwise(arr, amax=...)`` / ``quantize_stream(amax_fn=...)`` to
    skip the host reduction when the tensor is on the card."""
    return launch_block_amax(x).cpu().numpy()


def launch_amax(leaves) -> Dict[str, torch.Tensor]:
    """:func:`launch_block_amax` of every quantizable CUDA leaf of
    ``[(name, leaf), ...]``, keyed by record name: one kernel launch
    each, all on the current stream, nothing synchronised."""
    return {name: launch_block_amax(leaf) for name, leaf in leaves
            if isinstance(leaf, torch.Tensor) and leaf.is_cuda
            and quantizable(dtype_name(leaf), leaf.numel())}


def amax_to_host(amax: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The device amax of :func:`launch_amax` on the host, in one
    device→host copy (it waits for the launches)."""
    if not amax:
        return {}
    names = list(amax)
    sizes = [amax[n].numel() for n in names]
    flat = torch.cat([amax[n] for n in names]).cpu().numpy()
    return dict(zip(names, np.split(flat, np.cumsum(sizes)[:-1])))


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
    scale = np.empty(nb, np.float32)
    q = torch.empty(nb * BLOCK, dtype=torch.int8)
    for b, k, lo, hi in _passes(n):
        rows = _f32_rows(flat, lo, hi, k)
        a = (rows.abs().amax(dim=1).numpy() if amax is None
             else amax[b:b + k])
        scale[b:b + k] = amax_to_scale(a)
        t = rows / torch.from_numpy(scale[b:b + k])[:, None]
        q[b * BLOCK:(b + k) * BLOCK] = t.round_().clamp_(-127, 127).view(-1)
    return q[:n].numpy(), scale


def _deblock(q, scale, dtype: str) -> torch.Tensor:
    """Inverse of :func:`_blockwise`: the flat ``dtype`` tensor of
    ``int8 · scale`` (f32 product, one rounding to ``dtype``)."""
    qt, st = _host_flat(q), _host_flat(scale)
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
                    amax_fn=None, amax: Optional[Dict[str, np.ndarray]] = None
                    ) -> Tuple[Manifest, List[np.ndarray]]:
    """Rewrite (manifest, buffers) with int8+scale record pairs for every
    quantizable tensor. Small/int tensors pass through unchanged.

    ``amax`` maps record names to per-block amax computed beforehand
    (the checkpointer's device amax, taken on the card before the
    snapshot was released); ``amax_fn(values) -> per-block amax`` plugs
    in a reduction per record (:func:`device_block_amax`). Records
    neither covers keep the host reduction."""
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
            a = (amax[rec.name] if amax is not None and rec.name in amax
                 else amax_fn(values) if amax_fn is not None else None)
            q, scale = _blockwise(values, amax=a)
            push(rec.name + _QUANT_SUFFIX, q, f"int8|{rec.dtype}",
                 rec.shape)
            push(rec.name + _SCALE_SUFFIX, scale, "float32", scale.shape)
        else:
            push(rec.name, buf, rec.dtype, rec.shape)
    m = Manifest(records, offset, dict(manifest.extras), manifest.treedef)
    m.extras["quantized"] = True
    return m, out


def dequantize_named(named: dict, manifest: Manifest) -> dict:
    """{name: tensor} from deserialize() -> original-dtype tensors."""
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
            out[base] = _deblock(arr, scale, orig).reshape(shapes[name])
        else:
            out[name] = arr
    return out
