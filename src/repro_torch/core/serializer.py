"""Checkpoint-state serialization (paper §2.1.3) on torch pytrees.

A checkpoint state is a pytree of tensors — nested dicts, NamedTuples,
lists and tuples — plus JSON-able extras (step, data-iterator state).
Serialization produces:

  * an ordered sequence of per-tensor byte segments, and
  * a manifest (tensor metadata: path, dtype, shape, offset, nbytes).

The stream is the reference's (``repro.core.serializer``) byte for byte:
leaves are visited in JAX's flatten order (dict keys SORTED, NamedTuple
fields in declaration order) and named with JAX's key-path rule
(``.field`` for NamedTuple fields, the key for dicts, the index for
sequences, joined with ``/``), and bf16 is stored as uint16. A
checkpoint written here loads in the reference and vice versa.

``ByteStreamView`` exposes the concatenated stream for byte-granularity
partitioning (§4.2): a writer's extent may begin/end mid-tensor; the
view yields zero-copy memoryview slices in stream order.
"""
from __future__ import annotations

import json
import zlib
from bisect import bisect_right
from dataclasses import dataclass, field, replace
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.tree import flatten, treedef_str, unflatten


def dtype_name(leaf) -> str:
    """Manifest dtype string (numpy naming: ``float32``, ``bfloat16``)."""
    return str(leaf.dtype).replace("torch.", "")


@dataclass(frozen=True)
class TensorRecord:
    name: str
    dtype: str
    shape: Tuple[int, ...]
    offset: int           # byte offset in the checkpoint stream
    nbytes: int


@dataclass
class Manifest:
    records: List[TensorRecord]
    total_bytes: int
    extras: dict = field(default_factory=dict)
    treedef: Optional[str] = None     # printable structure for debugging

    def to_json(self) -> str:
        return json.dumps({
            "records": [vars(r) for r in self.records],
            "total_bytes": self.total_bytes,
            "extras": self.extras,
            "treedef": self.treedef,
        })

    @classmethod
    def from_json(cls, s: str) -> "Manifest":
        d = json.loads(s)
        recs = [TensorRecord(r["name"], r["dtype"], tuple(r["shape"]),
                             r["offset"], r["nbytes"])
                for r in d["records"]]
        return cls(recs, d["total_bytes"], d.get("extras", {}),
                   d.get("treedef"))


def store_dtype(dtype_str: str) -> np.dtype:
    """On-stream numpy dtype for a manifest dtype string: bf16 is stored
    bit-cast to uint16 (THE on-stream layout rule, shared with the
    reference)."""
    if dtype_str == "bfloat16":
        return np.dtype(np.uint16)
    return np.dtype(dtype_str)


def host_bytes(leaf) -> np.ndarray:
    """Flat uint8 host copy/view of one leaf in on-stream layout (a
    device→host copy for CUDA tensors)."""
    if isinstance(leaf, np.ndarray):
        return np.ascontiguousarray(leaf).reshape(-1).view(np.uint8)
    t = leaf.detach().reshape(-1).contiguous()
    return t.view(torch.uint8).cpu().numpy()


def serialize(state, arena=None, track_dirty: bool = False,
              dirty_block: int = 4096, device_dirty: bool = False
              ) -> Tuple[Manifest, List[np.ndarray]]:
    """Flatten a checkpoint state into (manifest, ordered host buffers).

    With ``arena`` (a :class:`repro_torch.core.arena.SerializeArena`),
    buffers are views into the arena's persistent page-aligned staging
    memory (DESIGN.md §6); ``track_dirty`` records the dirty spans
    against the resident previous image in ``arena.last_dirty``
    (DESIGN.md §9). Without it, one fresh host copy per leaf."""
    return serialize_leaves(flatten(state), treedef_str(state), arena,
                            track_dirty=track_dirty, dirty_block=dirty_block,
                            device_dirty=device_dirty)


def serialize_leaves(leaves, treedef: str, arena=None,
                     track_dirty: bool = False, dirty_block: int = 4096,
                     device_dirty: bool = False, dtypes=None
                     ) -> Tuple[Manifest, List[np.ndarray]]:
    """:func:`serialize` of records given as ``[(name, leaf), ...]``
    with the state's ``treedef`` string. ``dtypes`` names the records
    whose manifest dtype is not their tensor's (a quantized save's
    ``int8|<orig>``, :func:`repro_torch.core.quant.quantize_leaves`):
    the layout, sizes and bytes follow the tensor (``decode_record``
    reads the part before the ``|``), and the name is set on the
    manifest's records afterwards."""
    if arena is not None:
        manifest, buffers = arena.serialize(leaves, treedef,
                                            track_dirty=track_dirty,
                                            dirty_block=dirty_block,
                                            device_dirty=device_dirty)
    else:
        records, buffers = [], []
        offset = 0
        for name, leaf in leaves:
            arr = host_bytes(leaf)
            records.append(TensorRecord(name, dtype_name(leaf),
                                        tuple(leaf.shape), offset,
                                        arr.nbytes))
            buffers.append(arr)
            offset += arr.nbytes
        manifest = Manifest(records, offset, treedef=treedef)
    if dtypes:
        manifest.records = [replace(r, dtype=dtypes.get(r.name, r.dtype))
                            for r in manifest.records]
    return manifest, buffers


def begin_snapshot(state, arena, chunk_bytes: int, *,
                   track_dirty: bool = False, dirty_block: int = 4096,
                   device_dirty: bool = False):
    """Chunked-snapshot variant of :func:`serialize` (DESIGN.md §10):
    lays out the stream against ``arena`` without copying and returns
    ``(manifest, buffers, progress, fill)`` — the caller runs ``fill``
    on a snapshot worker and gates writer segments on ``progress``."""
    return arena.begin_snapshot(flatten(state), treedef_str(state),
                                chunk_bytes, track_dirty=track_dirty,
                                dirty_block=dirty_block,
                                device_dirty=device_dirty)


def to_tensor(arr: np.ndarray, dtype_str: str) -> torch.Tensor:
    """Zero-copy CPU tensor over an on-stream array (bf16 from its
    uint16 bits)."""
    if not arr.flags.writeable:
        arr = arr.copy()
    if dtype_str == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def decode_record(rec: TensorRecord, raw) -> torch.Tensor:
    """Rebuild ONE tensor (CPU, zero-copy over ``raw``) from its raw
    bytes, with the reshape guard for synthetic ``#`` records whose
    element count differs from the original tensor shape."""
    dtype = rec.dtype.split("|")[0]
    arr = np.frombuffer(raw, store_dtype(dtype))
    if rec.name.find("#") < 0 or arr.size == int(np.prod(rec.shape)):
        arr = arr.reshape(rec.shape)
    return to_tensor(arr, dtype)


def deserialize(manifest: Manifest, data: bytes | bytearray | memoryview,
                like=None):
    """Rebuild tensors from the checkpoint stream. If ``like`` (a pytree
    of the same structure; its leaves may be ``meta`` tensors) is given,
    returns that structure; otherwise a flat {name: tensor} dict. The
    tensors are CPU views into ``data``."""
    out = {}
    mv = memoryview(data)
    for rec in manifest.records:
        out[rec.name] = decode_record(rec, mv[rec.offset:rec.offset
                                              + rec.nbytes])
    if like is not None:
        return unflatten(like, out)
    return out


def tensor_spans(records: Sequence[TensorRecord],
                 extents) -> dict:
    """Global index for the sharded layout (DESIGN.md §5): map every
    tensor to the ``[shard_index, offset_in_shard, length]`` spans that
    hold its bytes. Extents are disjoint and sorted by offset, so their
    END offsets are monotonic — bisect to the first extent that can
    overlap a record, then walk forward."""
    exts = sorted(extents, key=lambda e: e.offset)
    ends = [e.offset + e.length for e in exts]
    index: dict = {}
    for rec in records:
        spans = []
        lo, hi = rec.offset, rec.offset + rec.nbytes
        i = bisect_right(ends, lo)
        while i < len(exts) and exts[i].offset < hi:
            e = exts[i]
            if e.offset + e.length > lo:
                s, t = max(lo, e.offset), min(hi, e.offset + e.length)
                spans.append([e.shard_index, s - e.offset, t - s])
            i += 1
        index[rec.name] = spans
    return index


class ByteStreamView:
    """Zero-copy view of the ordered tensor buffers as one byte stream."""

    def __init__(self, buffers: Sequence[np.ndarray]):
        self._views = [memoryview(b).cast("B") for b in buffers]
        self._offsets = np.cumsum([0] + [v.nbytes for v in self._views])
        self.total = int(self._offsets[-1])

    def slices(self, start: int, length: int) -> Iterator[memoryview]:
        """Yield memoryview chunks covering [start, start+length)."""
        assert 0 <= start and start + length <= self.total
        end = start + length
        i = int(np.searchsorted(self._offsets, start, "right")) - 1
        while start < end and i < len(self._views):
            v = self._views[i]
            base = int(self._offsets[i])
            lo = start - base
            hi = min(end - base, v.nbytes)
            if hi > lo:
                yield v[lo:hi]
            start = base + hi
            i += 1

    def read(self, start: int, length: int) -> memoryview:
        """Materialize [start, start+length) into ONE preallocated
        buffer."""
        out = bytearray(length)
        pos = 0
        for s in self.slices(start, length):
            out[pos:pos + s.nbytes] = s
            pos += s.nbytes
        return memoryview(out)

    def crc32(self, start: int = 0, length: Optional[int] = None) -> int:
        length = self.total - start if length is None else length
        c = 0
        for s in self.slices(start, length):
            c = zlib.crc32(s, c)
        return c
