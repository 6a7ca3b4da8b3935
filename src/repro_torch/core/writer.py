"""NVMe-optimized write engine (paper §4.1).

Implements the paper's single-rank write path, adapted to this host (see
DESIGN.md §2, §6):

  * **direct I/O** — ``O_DIRECT`` file descriptors with sector-aligned
    staging buffers. Falls back to buffered I/O transparently where
    O_DIRECT is unsupported (tmpfs), preserving identical semantics.
  * **async submission** — staging buffers are handed to an
    :mod:`repro_torch.core.aio` submitter (io_uring > libaio > pwrite-threads,
    capability-probed) with ``queue_depth`` writes in flight, so deep
    NVMe queues are actually exercised. ``queue_depth + 1`` staging
    buffers keep the fill of chunk *i+1* overlapping the flush of
    chunks *i, i-1, …* (the paper's double buffering, generalized).
  * **prefix/suffix alignment split** — the largest aligned prefix goes
    through the direct path; the <alignment-sized suffix is appended with
    a buffered descriptor into the SAME file: no padding, no format break.
  * **pending-byte coalescing** — serialized-tensor segments of arbitrary
    size are staged into the IO buffer and flushed only at alignment
    boundaries, preserving byte order exactly (bytes of one tensor may
    span writes; one write may span tensors).
  * **single-pass integrity** — CRC32 accumulates over each staging
    buffer as it is filled (the bytes are LLC-hot from the copy), so the
    checkpoint stream is traversed exactly once on the write path; no
    caller needs a second full sweep (Check-N-Run folds checks into the
    write path the same way).

Single-buffer mode (``double_buffer=False``) is genuinely synchronous —
one staging buffer, each flush completes before the next fill starts —
so fig7's 1-buffer datapoint measures the absence of overlap.
"""
from __future__ import annotations

import os
import time
import zlib
from dataclasses import dataclass
from typing import Iterable, Optional

from repro_torch import spans
from repro_torch.core import aio

DEFAULT_ALIGN = 4096


def aligned_buffer(size: int, align: int = DEFAULT_ALIGN) -> memoryview:
    """Page-locked-style staging buffer whose base address is aligned."""
    import numpy as np
    raw = np.empty(size + align, dtype=np.uint8)
    addr = raw.ctypes.data
    off = (-addr) % align
    return memoryview(raw)[off:off + size]


def open_direct(path: str, align: int) -> tuple[int, bool]:
    """Open for writing with O_DIRECT if the filesystem supports it.
    Returns (fd, is_direct)."""
    flags = os.O_WRONLY | os.O_CREAT
    if hasattr(os, "O_DIRECT"):
        try:
            fd = os.open(path, flags | os.O_DIRECT, 0o644)
            return fd, True
        except OSError:
            pass
    return os.open(path, flags, 0o644), False


@dataclass
class WriterConfig:
    io_buffer_size: int = 32 * 1024 * 1024
    double_buffer: bool = True       # async flush + queue_depth in flight
    use_direct: bool = True
    alignment: int = DEFAULT_ALIGN
    #: submission backend: "auto" | "io_uring" | "libaio" | "pwrite".
    #: $FASTPERSIST_IO_BACKEND overrides; unavailable backends fall back
    #: to pwrite (see repro_torch.core.aio).
    backend: str = "auto"
    #: in-flight writes per stream; staging memory is
    #: (queue_depth + 1) * io_buffer_size when double_buffer is on.
    queue_depth: int = 2
    #: accumulate CRC32 during the fill phase (WriteStats.crc32)
    checksum: bool = True


@dataclass
class WriteStats:
    bytes_written: int = 0
    seconds: float = 0.0
    flush_seconds: float = 0.0     # staging→disk (pwrite time, or time
    #                                blocked on async completions)
    crc_seconds: float = 0.0       # fill-phase CRC (write.crc spans)
    n_writes: int = 0
    direct: bool = False
    backend: str = "pwrite"        # resolved submission backend
    crc32: Optional[int] = None    # stream CRC32 (None if checksum off)
    #: time the fill phase spent blocked waiting for its SOURCE (the
    #: chunked-snapshot gate, DESIGN.md §10) rather than copying —
    #: reported by gated segment iterables, 0.0 for plain streams; the
    #: ``write.copy`` spans include it.
    source_wait_seconds: float = 0.0

    @property
    def gbps(self) -> float:
        return self.bytes_written / max(self.seconds, 1e-12) / 1e9


def write_stream(path: str, segments: Iterable[memoryview], total: int,
                 config: WriterConfig, file_offset: int = 0) -> WriteStats:
    """Write ``segments`` (in order, ``total`` bytes) to ``path`` starting
    at ``file_offset`` using the FastPersist §4.1 write path."""
    cfg = config
    stats = WriteStats()
    align = cfg.alignment
    # O_DIRECT additionally requires the FILE offset to be aligned;
    # shard files start at 0 so this holds for the default layout.
    want_direct = cfg.use_direct and file_offset % align == 0
    fd, is_direct = (open_direct(path, align) if want_direct
                     else (os.open(path, os.O_WRONLY | os.O_CREAT, 0o644),
                           False))
    stats.direct = is_direct

    prefix = (total // align) * align if is_direct else total
    suffix = total - prefix

    backend = aio.resolve_backend(cfg.backend)
    stats.backend = backend
    depth = max(1, cfg.queue_depth) if cfg.double_buffer else 1
    nbuf = depth + 1 if cfg.double_buffer else 1
    bufs = [aligned_buffer(cfg.io_buffer_size, align) for _ in range(nbuf)]
    flusher = aio.make_submitter(backend, fd, depth,
                                 inline=not cfg.double_buffer)
    tickets: list = [None] * nbuf
    crc: Optional[int] = 0 if cfg.checksum else None

    t0 = time.perf_counter()
    seg_iter = iter(segments)
    # gated sources (chunked snapshots, DESIGN.md §10) expose
    # would_block(): instead of idling behind the gate with a
    # partially-filled staging buffer, flush what is already staged —
    # the first NVMe submission happens after the FIRST chunk lands,
    # not once a whole io_buffer's worth has crossed from the device
    would_block = getattr(segments, "would_block", None)
    pending: Optional[memoryview] = None   # unconsumed tail of a segment
    written = 0          # bytes handed to the flusher (aligned region)
    bi = 0
    try:
        while written < prefix:
            buf = bufs[bi]
            # buffer recycling: its previous write must have landed
            if tickets[bi] is not None:
                with spans.span("write.wait"):
                    flusher.wait(tickets[bi])
                tickets[bi] = None
            target = min(cfg.io_buffer_size, prefix - written)
            # ---- fill phase: device→staging copy (coalescing queue) ----
            filled = 0
            with spans.span("write.copy") as sp:
                while filled < target:
                    if pending is None:
                        # early flush: submit the aligned bytes in hand
                        # rather than waiting for the snapshot watermark
                        if (filled and filled % align == 0
                                and would_block is not None
                                and would_block()):
                            break
                        try:
                            pending = next(seg_iter)
                        except StopIteration:
                            break
                    take = min(len(pending), target - filled)
                    buf[filled:filled + take] = pending[:take]
                    pending = pending[take:] if take < len(pending) \
                        else None
                    filled += take
                sp.nbytes = filled
            if filled == 0:        # segments exhausted (total overstated)
                break
            if crc is not None:    # single-pass integrity: bytes are hot
                with spans.timed("write.crc", filled) as sp:
                    crc = zlib.crc32(buf[:filled], crc)
                stats.crc_seconds += sp.seconds
            # ---- flush phase: staging→disk, queue_depth in flight ------
            tickets[bi] = flusher.submit(buf[:filled], file_offset + written)
            if not cfg.double_buffer:       # synchronous single-buffer
                flusher.wait(tickets[bi])
                tickets[bi] = None
            written += filled
            bi = (bi + 1) % nbuf
        with spans.span("write.wait"):
            flusher.drain()
    finally:
        flusher.close()
        os.close(fd)
    stats.n_writes = flusher.n_writes
    stats.flush_seconds = flusher.flush_seconds

    if suffix:
        # buffered append of the unaligned tail into the SAME file
        with spans.span("write.copy") as sp:
            tail = bytearray()
            if pending is not None:
                tail += bytes(pending)
            for s in seg_iter:
                tail += bytes(s)
            tail = bytes(tail)[:suffix] if len(tail) > suffix \
                else bytes(tail)
            sp.nbytes = len(tail)
        if crc is not None and tail:
            with spans.timed("write.crc", len(tail)) as sp:
                crc = zlib.crc32(tail, crc)
            stats.crc_seconds += sp.seconds
        fd2 = os.open(path, os.O_WRONLY)
        tw = time.perf_counter()
        try:
            w = 0
            while w < len(tail):
                w += os.pwrite(fd2, tail[w:], file_offset + prefix + w)
        finally:
            os.close(fd2)
        stats.flush_seconds += time.perf_counter() - tw
        if tail:
            stats.n_writes += 1
        written += len(tail)

    stats.bytes_written = written
    stats.seconds = time.perf_counter() - t0
    stats.crc32 = crc
    stats.source_wait_seconds = float(getattr(segments, "wait_seconds",
                                              0.0))
    return stats
