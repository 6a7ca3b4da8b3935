"""Parallel restore read engine (paper §4.2's load-then-allgather;
DESIGN.md §7 — the span-read + CRC-combine half of the restore
pipeline, also reused by the §8 hydration path's integrity checks).

The write path streams byte extents to shard files with ``queue_depth``
writes in flight (:mod:`repro_torch.core.writer`); this module is its twin
for the restore direction. A reader rank's owned spans of one shard
file are read with the SAME submission backends (io_uring > libaio >
pwrite-threads, capability-probed for both directions) directly into
the destination buffer — no staging bounce, no per-span allocation:

    read_stream(path, [(file_off, dest_off, length), ...], dest, cfg)

Differences from the write path, on purpose:

  * **zero-copy destination** — reads land straight in ``dest`` (the
    reusable page-aligned arena buffer on the checkpoint path), so the
    only copy is kernel→buffer. The write path needs staging buffers
    because it coalesces arbitrary tensor segments; the read path's
    spans are already disk-contiguous.
  * **no O_DIRECT** — span offsets/lengths are byte-granular (a span
    may start mid-sector), so reads go through the page cache; the
    async queue still overlaps many spans per reader.
  * **per-span CRC, folded hot** — completions are waited for in
    submission order, and each chunk is CRC'd right after it lands
    (cache-hot), producing one CRC per span. Shard-level verification
    combines span CRCs with :func:`crc32_combine` — no second sweep
    over the assembled stream.
"""
from __future__ import annotations

import os
import time
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from repro_torch.core import aio


@dataclass
class ReadStats:
    """Per-call statistics for one shard file's span reads."""
    bytes_read: int = 0
    seconds: float = 0.0
    wait_seconds: float = 0.0      # time blocked on async completions
    crc_seconds: float = 0.0       # hot per-span CRC folding
    n_reads: int = 0               # kernel-level read submissions
    n_spans: int = 0
    backend: str = "pwrite"        # resolved submission backend
    #: CRC32 per input span (completion-order-independent: chunks are
    #: folded in file order), or None when ``config.checksum`` is off
    span_crcs: Optional[List[int]] = None

    @property
    def gbps(self) -> float:
        return self.bytes_read / max(self.seconds, 1e-12) / 1e9


def read_stream(path: str, spans: Sequence[Tuple[int, int, int]],
                dest: memoryview, config) -> ReadStats:
    """Read ``spans`` — ``(file_offset, dest_offset, length)`` triples —
    from ``path`` into ``dest`` with ``config.queue_depth`` reads in
    flight through the resolved submission backend.

    ``config`` is a :class:`repro_torch.core.writer.WriterConfig` (the reader
    reuses its ``backend``/``queue_depth``/``io_buffer_size``/
    ``checksum`` knobs — one tuning surface for both directions). Spans
    larger than ``io_buffer_size`` are split into multiple in-flight
    submissions; bytes always land at their exact ``dest_offset``, so
    concurrent readers of DIFFERENT spans may share one ``dest``."""
    stats = ReadStats(n_spans=len(spans))
    backend = aio.resolve_backend(config.backend)
    stats.backend = backend
    depth = max(1, config.queue_depth)
    chunk_size = max(1, config.io_buffer_size)
    want_crc = getattr(config, "checksum", False)
    crcs: Optional[List[int]] = [0] * len(spans) if want_crc else None

    mv = memoryview(dest)
    fd = os.open(path, os.O_RDONLY)
    sub = aio.make_submitter(backend, fd, depth)
    inflight: deque = deque()     # (ticket, span_idx, dest_lo, length)

    def complete_one():
        ticket, si, lo, ln = inflight.popleft()
        t0 = time.perf_counter()
        sub.wait(ticket)
        stats.wait_seconds += time.perf_counter() - t0
        if crcs is not None:
            tc = time.perf_counter()
            # chunks of one span are waited for in submission (= file)
            # order, so the running fold equals the span's stream CRC
            crcs[si] = zlib.crc32(mv[lo:lo + ln], crcs[si])
            stats.crc_seconds += time.perf_counter() - tc

    t0 = time.perf_counter()
    try:
        for si, (file_off, dest_off, length) in enumerate(spans):
            done = 0
            while done < length:
                take = min(chunk_size, length - done)
                while len(inflight) >= depth:
                    complete_one()
                lo = dest_off + done
                ticket = sub.submit_read(mv[lo:lo + take], file_off + done)
                inflight.append((ticket, si, lo, take))
                done += take
                stats.bytes_read += take
        while inflight:
            complete_one()
        sub.drain()
    finally:
        sub.close()
        os.close(fd)
    stats.seconds = time.perf_counter() - t0
    stats.n_reads = sub.n_reads
    stats.span_crcs = crcs
    return stats


def file_crc32(path: str, size: int, config=None) -> int:
    """Whole-file CRC32 through the async span reader (one span, CRC
    folded hot) — the same read path restores use, so a backend whose
    reads are broken fails here too instead of 'verifying' garbage.
    Shared by the hydration/upload tiers and the serving read cache."""
    if size == 0:
        return 0
    from repro_torch.core.writer import WriterConfig
    cfg = config or WriterConfig()
    if not getattr(cfg, "checksum", False):
        from dataclasses import replace
        cfg = replace(cfg, checksum=True)
    dest = memoryview(bytearray(size))
    st = read_stream(path, [(0, 0, size)], dest, cfg)
    return st.span_crcs[0]


# ------------------------------------------------------- CRC32 algebra
def _gf2_matrix_times(mat: List[int], vec: int) -> int:
    s = 0
    i = 0
    while vec:
        if vec & 1:
            s ^= mat[i]
        vec >>= 1
        i += 1
    return s


def _gf2_matrix_square(square: List[int], mat: List[int]):
    for n in range(32):
        square[n] = _gf2_matrix_times(mat, mat[n])


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC32 of the concatenation A+B from ``crc32(A)``, ``crc32(B)``
    and ``len(B)`` (zlib's crc32_combine, which the ``zlib`` module
    does not expose). This is what lets N parallel readers each CRC
    only their own spans and still verify a shard's manifest CRC
    exactly — O(32² · log len2) bit-matrix work per merge, no second
    pass over the data."""
    if len2 <= 0:
        return crc1
    even = [0] * 32             # operator for 2^k zero bytes
    odd = [0] * 32
    # odd = operator for one zero bit: the CRC polynomial, reflected
    odd[0] = 0xEDB88320
    row = 1
    for n in range(1, 32):
        odd[n] = row
        row <<= 1
    _gf2_matrix_square(even, odd)      # 2 zero bits
    _gf2_matrix_square(odd, even)      # 4 zero bits → operator per byte²
    while True:
        _gf2_matrix_square(even, odd)
        if len2 & 1:
            crc1 = _gf2_matrix_times(even, crc1)
        len2 >>= 1
        if len2 == 0:
            break
        _gf2_matrix_square(odd, even)
        if len2 & 1:
            crc1 = _gf2_matrix_times(odd, crc1)
        len2 >>= 1
        if len2 == 0:
            break
    return crc1 ^ crc2


def combine_span_crcs(parts: Sequence[Tuple[int, int, int]],
                      expect_length: Optional[int] = None) -> Optional[int]:
    """Fold ``(offset, length, crc32)`` parts into the CRC of the whole
    region they tile. Returns None when the parts do NOT tile a
    contiguous ``[0, expect_length)`` region (partial/owned-only reads
    cannot be verified against a whole-shard CRC). Zero-length parts
    are ignored."""
    parts = sorted((p for p in parts if p[1] > 0), key=lambda p: p[0])
    pos = 0
    crc = 0
    for off, length, c in parts:
        if off != pos:
            return None
        crc = crc32_combine(crc, c, length)
        pos += length
    if expect_length is not None and pos != expect_length:
        return None
    return crc
