"""Incremental delta checkpoints: dirty-range tracking + keyframe/delta
generations (layout v3; DESIGN.md §9). A copy of ``repro.core.delta``;
the stream and span-table formats are the reference's.

Per-iteration checkpointing (the paper's fig13 regime) rewrites every
byte of the serialized stream every step, yet between adjacent optimizer
steps most of that stream is unchanged — embedding rows that saw no
token, optimizer slots of frozen layers, integer step counters.
Check-N-Run [NSDI'22] and LC-Checkpoint [ICML'20] both show that writing
only the CHANGED bytes (plus an occasional full "keyframe") cuts
checkpoint bandwidth/storage by an order of magnitude without giving up
bit-faithful restores.

This module is the core of that subsystem:

  * :func:`dirty_byte_spans` — the blockwise dirty-range tracker. The
    :class:`~repro_torch.core.arena.SerializeArena` already holds the PREVIOUS
    save's full host image, so during the device→arena copy each
    record's incoming bytes are compared against the resident image in
    aligned ``block``-sized chunks; runs of dirty blocks coalesce into
    ``(offset, length)`` byte spans. The tracking rule: a block is dirty
    iff ANY byte differs, and a span never crosses a record boundary
    (so every span has a single dtype — the quantizer relies on this).
  * :class:`DeltaSpan` / :class:`DeltaPlan` — the dirty-span table a
    delta generation persists (in its manifest meta AND its COMMIT
    marker): stream offsets into the FULL checkpoint stream, offsets
    into the PACKED delta payload, per-span encoding + CRC32 of the
    packed bytes, and the base-generation identity
    ``(base_step, base_gen)`` the delta chains off. Striped delta
    generations (multi-writer, DESIGN.md §13) extend every row with
    its destination ``[shard, shard_offset]`` in the per-volume shard
    layout — :func:`assign_span_shards` stamps them from the write
    plan's §7 ``stripe_ranges`` carve of the packed stream.
  * :func:`build_delta` — packs the dirty spans of a serialized stream
    into the delta payload buffers the existing partition/writer
    machinery then stripes to disk. (The reference's optional int8
    span encoding is not ported yet and raises.)
  * :func:`apply_delta` — the restore half: decode one generation's
    packed spans onto the reassembled base stream (replay order is
    keyframe first, then deltas oldest→newest, so the newest write of
    any byte wins).

Crash-atomicity and chain identity: every save carries a random
``generation`` nonce in its COMMIT marker; a delta records its base's
``(step, nonce)`` and restore refuses a chain whose base was re-saved
under a different nonce (TornCheckpointError) instead of silently
replaying onto the wrong image.
"""
from __future__ import annotations

from bisect import bisect_right
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import zlib


#: dirty-compare granularity (bytes). One page: fine enough that a
#: single touched embedding row does not drag a whole tensor into the
#: delta, coarse enough that the span table stays small.
DIRTY_BLOCK = 4096

_RAW = "raw"
_Q8 = "q8"


def _byte_view(arr) -> np.ndarray:
    """Flat uint8 view of an array/buffer (copy only if non-contiguous)."""
    a = np.ascontiguousarray(arr)
    return a.reshape(-1).view(np.uint8).reshape(-1)


def _coalesce_dirty_blocks(dirty: np.ndarray, block: int, n: int
                           ) -> List[Tuple[int, int]]:
    """Per-block bool dirty vector → coalesced (offset, length) byte
    spans; the final span is clipped to the ``n``-byte buffer."""
    idx = np.flatnonzero(dirty)
    if idx.size == 0:
        return []
    breaks = np.flatnonzero(np.diff(idx) > 1)
    starts = np.concatenate(([idx[0]], idx[breaks + 1]))
    ends = np.concatenate((idx[breaks], [idx[-1]])) + 1
    return [(int(s) * block, min(int(e) * block, n) - int(s) * block)
            for s, e in zip(starts, ends)]


def dirty_byte_spans(prev, new, block: int = DIRTY_BLOCK
                     ) -> List[Tuple[int, int]]:
    """Coalesced ``(offset, length)`` byte spans where ``new`` differs
    from ``prev``, aligned to ``block`` boundaries (the last span is
    clipped to the buffer length). Empty list == nothing changed."""
    a, b = _byte_view(prev), _byte_view(new)
    if a.size != b.size:
        raise ValueError(f"dirty compare size mismatch: {a.size} vs "
                         f"{b.size} bytes")
    n = a.size
    if n == 0:
        return []
    nfull = n // block
    tail = n - nfull * block
    dirty = np.zeros(nfull + (1 if tail else 0), dtype=bool)
    if nfull:
        head_a = a[:nfull * block].reshape(nfull, block)
        head_b = b[:nfull * block].reshape(nfull, block)
        dirty[:nfull] = (head_a != head_b).any(axis=1)
    if tail:
        dirty[nfull] = not np.array_equal(a[nfull * block:],
                                          b[nfull * block:])
    return _coalesce_dirty_blocks(dirty, block, n)


def mask_to_spans(mask, block: int, nbytes: int) -> List[Tuple[int, int]]:
    """Device change-mask → coalesced byte spans, same contract as
    :func:`dirty_byte_spans` (block-aligned, last span clipped to
    ``nbytes``). ``mask`` is the per-block int/bool vector the
    ``kernels.ops.ckpt_pack_dirty`` kernel emitted; blocks past the
    stream's end (pad blocks) are ignored — the pad rule (zero-pad on
    both sides of the compare) guarantees they are never dirty anyway."""
    if nbytes == 0:
        return []
    m = np.asarray(mask).reshape(-1).astype(bool)
    nblocks = -(-nbytes // block)
    return _coalesce_dirty_blocks(m[:nblocks], block, nbytes)


# ------------------------------------------------------------ span table
@dataclass(frozen=True)
class DeltaSpan:
    """One dirty span of the full checkpoint stream, as persisted.

    Striped delta generations (DESIGN.md §13) additionally record each
    span's DESTINATION in the multi-writer layout: ``shard`` is the
    shard file holding the span's first packed byte and
    ``shard_offset`` that byte's offset inside the file. Shard extents
    are contiguous in packed-stream order, so a span whose packed bytes
    straddle a shard boundary continues in shard+1 at offset 0.
    ``shard_offset == -1`` marks a pre-striping (single-stream) table
    with no destination columns."""
    offset: int          # byte offset in the FULL stream
    length: int          # decoded (raw) byte length
    packed_offset: int   # byte offset in the packed delta payload
    packed_length: int   # encoded byte length (== length for "raw")
    enc: str             # "raw" | "q8" (int8 blocks + f32 scales)
    crc32: int           # CRC of the PACKED payload bytes
    dtype: str = ""      # owning record's dtype (decode key for "q8")
    shard: int = 0       # shard file holding the span's first byte
    shard_offset: int = -1   # offset inside that shard (-1 = unstamped)

    def to_list(self) -> list:
        return [self.offset, self.length, self.packed_offset,
                self.packed_length, self.enc, self.crc32, self.dtype,
                self.shard, self.shard_offset]

    @classmethod
    def from_list(cls, row: Sequence) -> "DeltaSpan":
        # 7-column rows are pre-§13 tables (no per-shard destinations)
        off, length, poff, plen, enc, crc, dtype = row[:7]
        shard, shard_off = (row[7], row[8]) if len(row) > 8 else (0, -1)
        return cls(int(off), int(length), int(poff), int(plen), str(enc),
                   int(crc), str(dtype or ""), int(shard), int(shard_off))


@dataclass
class DeltaPlan:
    """The dirty-span table of ONE delta generation plus its chain
    identity. Serialized (``to_meta``) into both the manifest meta and
    the COMMIT marker, so chain resolution works before any payload
    shard is opened — and survives standalone (no-COMMIT) saves."""
    base_step: int
    base_gen: str        # base COMMIT's ``generation`` nonce
    gen: str             # this save's generation nonce
    stream_bytes: int    # FULL stream size (== the keyframe's)
    spans: List[DeltaSpan] = field(default_factory=list)

    @property
    def dirty_bytes(self) -> int:
        return sum(s.length for s in self.spans)

    @property
    def packed_bytes(self) -> int:
        return sum(s.packed_length for s in self.spans)

    def to_meta(self) -> dict:
        return {"base_step": self.base_step, "base_gen": self.base_gen,
                "gen": self.gen, "stream_bytes": self.stream_bytes,
                "dirty_bytes": self.dirty_bytes,
                "packed_bytes": self.packed_bytes,
                "spans": [s.to_list() for s in self.spans]}

    @classmethod
    def from_meta(cls, meta: dict) -> "DeltaPlan":
        return cls(base_step=int(meta["base_step"]),
                   base_gen=str(meta.get("base_gen", "")),
                   gen=str(meta.get("gen", "")),
                   stream_bytes=int(meta["stream_bytes"]),
                   spans=[DeltaSpan.from_list(r)
                          for r in meta.get("spans", [])])


def _extent_fields(e) -> Tuple[int, int, int]:
    """(offset, length, shard_index) of a plan extent — accepts the
    in-memory ``partition.Extent`` and the manifest's extent dict."""
    if isinstance(e, dict):
        return int(e["offset"]), int(e["length"]), int(e["shard_index"])
    return int(e.offset), int(e.length), int(e.shard_index)


def assign_span_shards(extents, spans: Sequence[DeltaSpan]
                       ) -> List[DeltaSpan]:
    """Stamp each span's destination ``[shard, shard_offset]`` from the
    write plan carved over the packed stream (DESIGN.md §13).

    ``extents`` is the striped write plan's extent list (the §7
    ``stripe_ranges`` carve of ``[0, packed_bytes)``). Each span records
    the shard holding its FIRST packed byte; extents are contiguous in
    packed order, so a boundary-straddling span continues in the next
    shard at offset 0 — q8 spans stay whole either way (splitting a
    packed q8 payload would orphan its trailing scale block).

    Raises ``ValueError`` when a span's start lies outside every
    extent (the plan does not cover the packed stream)."""
    if not spans:
        return []
    exts = sorted((_extent_fields(e) for e in extents),
                  key=lambda t: t[0])
    exts = [t for t in exts if t[1] > 0]       # zero-length carve tails
    starts = [t[0] for t in exts]
    out: List[DeltaSpan] = []
    for s in spans:
        i = bisect_right(starts, s.packed_offset) - 1
        if i < 0 or not (exts[i][0] <= s.packed_offset
                         < exts[i][0] + exts[i][1]):
            raise ValueError(
                f"packed span @{s.packed_offset} (+{s.packed_length}) "
                f"outside every plan extent — the carve does not cover "
                f"the packed stream")
        off, _length, shard = exts[i]
        out.append(DeltaSpan(s.offset, s.length, s.packed_offset,
                             s.packed_length, s.enc, s.crc32, s.dtype,
                             shard=shard,
                             shard_offset=s.packed_offset - off))
    return out


# ------------------------------------------------------------- encoding
#: the reference's int8 delta spans wait for the quantized-save slice
_Q8_TODO = ("int8-quantized delta spans (delta_quantize) are not ported "
            "yet: ROADMAP.md queue A item 4, quantized saves")


def encode_span(raw, dtype: str, quantize: bool
                ) -> Tuple[np.ndarray, str]:
    """``(payload_bytes, enc)`` for one dirty span: the raw bytes.
    ``quantize`` (the reference's lossy ``q8`` encoding) is not ported."""
    if quantize:
        raise NotImplementedError(_Q8_TODO)
    return _byte_view(np.frombuffer(raw, np.uint8)), _RAW


def decode_span(payload, enc: str, dtype: str, length: int) -> bytes:
    """Inverse of :func:`encode_span`: raw stream bytes of ``length``."""
    if enc == _Q8:
        raise NotImplementedError(_Q8_TODO)
    if enc != _RAW:
        raise IOError(f"unknown delta span encoding {enc!r}")
    if len(payload) != length:
        raise IOError(f"checkpoint corruption: raw delta span is "
                      f"{len(payload)} bytes, expected {length}")
    return bytes(payload)


# ----------------------------------------------------------- build side
def build_delta(records, view, dirty: Sequence[Tuple[int, int]], *,
                base_step: int, base_gen: str, gen: str,
                quantize: bool = False
                ) -> Tuple[DeltaPlan, List[np.ndarray]]:
    """Pack the dirty spans of a serialized stream into a delta payload.

    Args:
        records: the manifest's TensorRecords (stream layout).
        view: a :class:`~repro_torch.core.serializer.ByteStreamView` over the
            FULL stream buffers.
        dirty: ``(offset, length)`` spans from the arena's tracker —
            guaranteed not to cross record boundaries.
        quantize: int8-quantize float spans (not ported: raises).

    Returns:
        ``(plan, payloads)`` where ``payloads`` is the list of packed
        per-span buffers — a ByteStreamView over it is what the
        partition/writer machinery stripes to disk.
    """
    recs = sorted(records, key=lambda r: r.offset)
    starts = [r.offset for r in recs]
    spans: List[DeltaSpan] = []
    payloads: List[np.ndarray] = []
    poff = 0
    for off, length in sorted(dirty):
        i = bisect_right(starts, off) - 1
        rec = recs[i]
        if off + length > rec.offset + rec.nbytes:
            raise ValueError(f"dirty span ({off},{length}) crosses record "
                             f"boundary of {rec.name!r}")
        segs = list(view.slices(off, length))
        raw = segs[0] if len(segs) == 1 else view.read(off, length)
        payload, enc = encode_span(raw, rec.dtype, quantize)
        payloads.append(np.frombuffer(payload, np.uint8)
                        if not isinstance(payload, np.ndarray) else payload)
        spans.append(DeltaSpan(off, length, poff, int(payloads[-1].nbytes),
                               enc, zlib.crc32(payloads[-1]), rec.dtype))
        poff += int(payloads[-1].nbytes)
    return (DeltaPlan(base_step=base_step, base_gen=base_gen, gen=gen,
                      stream_bytes=view.total, spans=spans), payloads)


# --------------------------------------------------------- restore side
def apply_delta(dest, plan: DeltaPlan, packed, verify: bool = True
                ) -> int:
    """Replay one delta generation onto ``dest`` (the reassembled base
    stream). Callers replay chains oldest→newest so the newest write of
    any byte wins. Returns the number of decoded bytes applied.

    With ``verify`` each span's packed bytes are CRC-checked before
    decoding — corruption raises ``IOError('checkpoint corruption…')``
    exactly like the shard-level checks of the full-checkpoint path."""
    dmv = memoryview(dest).cast("B") if not isinstance(dest, memoryview) \
        else dest.cast("B")
    if len(dmv) < plan.stream_bytes:
        raise ValueError(f"delta target holds {len(dmv)} bytes; the "
                         f"stream needs {plan.stream_bytes}")
    pmv = memoryview(packed).cast("B") if not isinstance(packed, memoryview) \
        else packed.cast("B")
    applied = 0
    for s in plan.spans:
        payload = pmv[s.packed_offset:s.packed_offset + s.packed_length]
        if len(payload) != s.packed_length:
            raise IOError("checkpoint corruption: truncated delta payload")
        if verify:
            crc = zlib.crc32(payload)
            if crc != s.crc32:
                raise IOError(
                    f"checkpoint corruption: delta span @{s.offset} "
                    f"(+{s.length}) crc {crc:#010x} != {s.crc32:#010x}")
        dmv[s.offset:s.offset + s.length] = \
            decode_span(payload, s.enc, s.dtype, s.length)
        applied += s.length
    return applied
