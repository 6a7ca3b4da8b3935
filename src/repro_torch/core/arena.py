"""Persistent staging arena for checkpoint serialization (paper
§4.1/§4.3; DESIGN.md §6, plus the §7 read-staging rules), on torch
tensors that live on a CUDA card or the CPU.

A :class:`SerializeArena` owns ONE page-aligned host buffer sized to the
checkpoint stream and keyed by the state's structure (names × dtypes ×
shapes × device):

  * the FIRST save lays out the stream and allocates the buffer — for a
    state on the card the buffer is pinned with ``cudaHostRegister``
    (and unregistered when it is regrown or freed), so device→host
    copies run as DMA at full PCIe rate, and it stays page-aligned for
    the writers' O_DIRECT path;
  * STEADY-STATE saves copy device→arena in place;
  * a shape/structure change (or :meth:`invalidate`) re-lays-out, and
    re-allocates ONLY if the new stream is larger than the capacity.

Device→host copies (DESIGN.md §10). A fill runs on a side CUDA stream
that first waits on an event recorded on the compute stream when the
snapshot begins (after the train step). Each chunk is sliced ON THE
DEVICE and copied with ``copy_(non_blocking=True)`` straight into the
pinned arena; the byte watermark (:class:`SnapshotProgress`) advances
only once that chunk's CUDA event has completed.

Device-dirty snapshots: float records keep a packed previous image
RESIDENT on the card; the ckpt_pack_dirty CUDA kernel compares against
it, only dirty blocks (gathered on the device, one copy) and the mask
cross PCIe, and they are scattered into the arena. The baseline is
always NEW storage: the optimizer updates parameters in place, and a
baseline that aliased one would read as clean when it is dirty.

The arena also stages RESTORES (:meth:`read_buffer`), in a separate
backing allocation, so an overlapped save never scribbles over a load.
Lifetime rules as in the reference: one arena must not be refilled
while a previous save still reads it (the engine's single helper thread
serializes saves); tensors deserialized from :meth:`read_buffer` are
views into it, valid until the next load on the same arena.
"""
from __future__ import annotations

import collections
import threading
import weakref
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core.serializer import (Manifest, TensorRecord, dtype_name,
                                         store_dtype)
from repro_torch.core.writer import aligned_buffer

PAGE = 4096

#: dtypes the device-dirty snapshot path handles (the pack kernel is
#: bit-preserving for these; everything else host-compares)
_DEV_DTYPES = ("float32", "bfloat16", "float16")

#: async device→arena chunk copies kept in flight before the watermark
#: waits on the oldest one
_COPY_WINDOW = 4


def _pin(buf: np.ndarray):
    """Page-lock ``buf`` for DMA (cudaHostRegister); unregistered when
    ``buf`` is collected. Raises if registration fails: a silently
    unpinned staging buffer would halve the copy rate unnoticed."""
    cudart = torch.cuda.cudart()
    ptr, size = buf.ctypes.data, buf.nbytes
    err = cudart.cudaHostRegister(ptr, size, 0)
    if err != cudart.cudaError.success:
        raise RuntimeError(f"cudaHostRegister of the {size}-byte staging "
                           f"arena failed: {err}")
    weakref.finalize(buf, cudart.cudaHostUnregister, ptr)


class _LeafBytes:
    """Byte-range source over one leaf, in on-stream layout. A tensor's
    pieces are sliced on its own device, so only each piece's bytes
    cross PCIe."""

    def __init__(self, leaf):
        if isinstance(leaf, torch.Tensor):
            flat = leaf.detach().reshape(-1)
            self._flat8 = flat.contiguous().view(torch.uint8)
        else:
            self._flat8 = torch.from_numpy(
                np.ascontiguousarray(leaf).reshape(-1).view(np.uint8))
        self.on_device = self._flat8.is_cuda

    def range(self, lo: int, hi: int) -> np.ndarray:
        """uint8 host copy/view of stream bytes [lo, hi) of this leaf
        (synchronous)."""
        return self._flat8[lo:hi].cpu().numpy()

    def copy_to(self, dst: torch.Tensor, lo: int, hi: int):
        """Enqueue the copy of bytes [lo, hi) into ``dst`` (a pinned
        host uint8 tensor) on the current stream."""
        dst.copy_(self._flat8[lo:hi], non_blocking=True)


class SnapshotProgress:
    """Byte watermark of an in-flight chunked device→arena snapshot.

    The fill worker ``advance()``s the watermark as each piece lands (in
    stream order, so a single monotonic counter is the whole "which
    chunks are filled" state); gated writer segments ``wait_until()``
    their bytes are covered before consuming them. A fill failure parks
    the exception here and re-raises at EVERY wait site — writers abort,
    the save raises, and the engine never reaches COMMIT (the §10
    crash-safety rule)."""

    def __init__(self, total: int, chunk_bytes: int):
        self.total = int(total)
        self.chunk_bytes = max(int(chunk_bytes), 1)
        self.n_chunks = max(1, -(-self.total // self.chunk_bytes))
        #: fill wall time, stamped when the fill worker finishes
        self.seconds = 0.0
        self._cond = threading.Condition()
        self._filled = 0
        self._exc: Optional[BaseException] = None
        self._done = False

    @property
    def filled(self) -> int:
        return self._filled

    @property
    def done(self) -> bool:
        return self._done

    @property
    def failed(self) -> bool:
        return self._exc is not None

    def advance(self, watermark: int):
        """Raise the filled-bytes watermark (monotonic; stream order)."""
        with self._cond:
            if watermark > self._filled:
                self._filled = int(watermark)
                self._cond.notify_all()

    def finish(self):
        with self._cond:
            self._filled = self.total
            self._done = True
            self._cond.notify_all()

    def fail(self, exc: BaseException):
        with self._cond:
            self._exc = exc
            self._done = True
            self._cond.notify_all()

    def wait_until(self, watermark: int):
        """Block until ``watermark`` stream bytes are staged; re-raises
        the fill worker's exception if the snapshot died."""
        watermark = min(int(watermark), self.total)
        with self._cond:
            while (self._filled < watermark and self._exc is None
                   and not self._done):
                self._cond.wait()
            if self._exc is not None:
                raise self._exc

    def wait_done(self):
        """Block until the whole snapshot landed (or failed)."""
        with self._cond:
            while not self._done:
                self._cond.wait()
            if self._exc is not None:
                raise self._exc


class SerializeArena:
    """Reusable page-aligned host staging buffer for one checkpoint
    stream. See module docstring for the lifecycle."""

    def __init__(self, alignment: int = PAGE):
        self.alignment = alignment
        self._key: Optional[tuple] = None
        self._mv: Optional[memoryview] = None    # aligned capacity window
        self._t8: Optional[torch.Tensor] = None  # the same window, as torch
        self._pinned = False
        self._records: Optional[list] = None     # cached TensorRecords
        self._buffers: Optional[List[np.ndarray]] = None  # per-record views
        self._treedef_str: Optional[str] = None
        self._total = 0
        self.capacity = 0
        self._device: Optional[torch.device] = None   # CUDA device or None
        self._stream = None                      # side stream of the fills
        # read-staging twin (restore path; separate backing)
        self._read_mv: Optional[memoryview] = None
        self.read_capacity = 0
        # --- observability (SaveStats / benchmarks read these) ---
        self.n_alloc = 0        # backing-buffer allocations
        self.n_layout = 0       # stream layouts (key misses)
        self.n_reuse = 0        # steady-state fills into cached layout
        self.last_reused = False
        # --- dirty-range tracking (delta checkpoints, DESIGN.md §9) ---
        #: stream-coordinate (offset, length) spans where the LAST
        #: serialize differed from the resident previous image; None
        #: when tracking was off or there was no valid baseline
        self.last_dirty: Optional[List[Tuple[int, int]]] = None
        # --- device-dirty snapshots (DESIGN.md §10) ---
        #: per-record device-resident packed previous images (kernel
        #: outputs, new storage); None entries fall back to the host path
        self._dev_prev: Optional[List[Any]] = None
        #: True iff the resident host image is a COMPLETE copy of the
        #: last fill
        self._image_valid = False
        #: bytes that crossed device→host during the last fill (masks +
        #: gathered dirty blocks on the device path; everything on the
        #: host path)
        self.last_d2h_bytes = 0

    # ------------------------------------------------------------ state
    def invalidate(self):
        """Drop the cached layout (NOT the backing memory). Call when the
        state object was replaced (restore, re-init)."""
        self._key = None
        self._records = None
        self._buffers = None
        self._dev_prev = None
        self._image_valid = False

    def _ensure_capacity(self, total: int, pin: bool):
        if self._mv is None or total > self.capacity \
                or (pin and not self._pinned):
            size = max(total, 1, self.capacity)
            # drop the old (possibly registered) buffer first: its
            # finalizer unregisters it before the memory is freed
            self._mv = self._t8 = self._buffers = None
            mv = aligned_buffer(size, self.alignment)
            buf = np.frombuffer(mv, np.uint8)
            if pin:
                _pin(buf)
            self._mv, self._pinned = mv, pin
            self._t8 = torch.from_numpy(buf)
            self.capacity = size
            self.n_alloc += 1

    # ------------------------------------------------------ read staging
    def read_buffer(self, nbytes: int) -> memoryview:
        """Reusable page-aligned READ-staging window of ``nbytes``
        (restore path): the first load allocates, steady-state loads
        reuse; contents are undefined until the caller fills them."""
        if self._read_mv is None or nbytes > self.read_capacity:
            size = max(nbytes, 1)
            self._read_mv = aligned_buffer(size, self.alignment)
            self.read_capacity = size
        return self._read_mv[:nbytes]

    # ----------------------------------------------------------- layout
    @staticmethod
    def _signature(leaves, treedef) -> tuple:
        sig = []
        for name, leaf in leaves:
            dev = leaf.device.type if isinstance(leaf, torch.Tensor) \
                else "cpu"
            sig.append((name, dtype_name(leaf), tuple(leaf.shape), dev))
        return (treedef, tuple(sig))

    def _layout(self, leaves, treedef, key):
        """Key miss: compute records/offsets from METADATA only (no
        device transfer), grow the buffer if needed, carve per-record
        views."""
        records, metas = [], []
        offset = 0
        for name, leaf in leaves:
            dt = dtype_name(leaf)
            shape = tuple(leaf.shape)
            sdt = store_dtype(dt)
            count = int(np.prod(shape, dtype=np.int64)) if shape else 1
            nbytes = count * sdt.itemsize
            records.append(TensorRecord(name, dt, shape, offset, nbytes))
            metas.append((offset, count, sdt, shape))
            offset += nbytes
        cuda = [leaf.device for _, leaf in leaves
                if isinstance(leaf, torch.Tensor) and leaf.is_cuda]
        self._device = cuda[0] if cuda else None
        self._ensure_capacity(offset, pin=self._device is not None)
        buffers = []
        for off, count, sdt, shape in metas:
            view = np.frombuffer(self._mv, dtype=sdt, count=count,
                                 offset=off)
            buffers.append(view.reshape(shape) if shape else view)
        self._key = key
        self._records = records
        self._buffers = buffers
        self._treedef_str = treedef
        self._total = offset
        self._dev_prev = None
        self._image_valid = False
        self.n_layout += 1

    # -------------------------------------------------------- serialize
    def _prepare(self, leaves, treedef):
        """Key check + (on miss) metadata-only layout; sets last_reused.
        Returns the compute-stream event the fill must wait on (None for
        a CPU state)."""
        key = self._signature(leaves, treedef)
        if key != self._key or self._buffers is None:
            n_alloc = self.n_alloc
            with spans.span("snapshot.alloc") as sp:
                self._layout(leaves, treedef, key)
                sp.nbytes = self.capacity if self.n_alloc > n_alloc else 0
            self.last_reused = False
        else:
            self.n_reuse += 1
            self.last_reused = True
        if self._device is None:
            return None
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self._device))
        return ready

    @staticmethod
    def _device_eligible(rec, dirty_block: int) -> bool:
        """Records the ckpt_pack_dirty kernel snapshots: float dtypes
        whose per-mask-block element count is a whole multiple of 1024
        (the reference's rule, kept so device and host paths produce the
        same spans), and at least one block long."""
        if rec.dtype not in _DEV_DTYPES or rec.nbytes < dirty_block:
            return False
        isz = store_dtype(rec.dtype).itemsize
        return dirty_block % isz == 0 and (dirty_block // isz) % 1024 == 0

    def _fill_record_device(self, leaf, dst, rec, prev2d, dirty,
                            dirty_block: int):
        """Device-mask snapshot of one record: the kernel compares the
        packed image against ``prev2d`` on the device; the mask comes to
        the host, the dirty rows are gathered with ``index_select`` on
        the device, copied to the host once and scattered into the arena
        span by span. Clean blocks are skipped — valid because the
        resident arena bytes equal the previous packed image
        (``_image_valid``) and the pack is bit-preserving. Returns
        (new prev2d, d2h bytes moved)."""
        from repro_torch.core.delta import mask_to_spans
        from repro_torch.kernels import ops
        elems = dirty_block // store_dtype(rec.dtype).itemsize
        packed2d, _amax, mask = ops.ckpt_pack_dirty(leaf, prev2d,
                                                    block=elems)
        mask_h = mask.cpu().numpy()
        d2h = mask_h.nbytes
        spans = mask_to_spans(mask_h, dirty_block, rec.nbytes)
        idx = np.flatnonzero(mask_h)
        if idx.size:
            rows = packed2d.index_select(
                0, torch.from_numpy(idx).to(packed2d.device))
            rows8 = rows.view(torch.uint8)
            if rows8.is_cuda:
                host = torch.empty(rows8.shape, dtype=torch.uint8,
                                   pin_memory=True)
                host.copy_(rows8)
            else:
                host = rows8
            d2h += rows8.numel()
            src8 = host.numpy().reshape(-1)
            dst8 = dst.reshape(-1).view(np.uint8)
            pos = 0
            for off, length in spans:
                dst8[off:off + length] = src8[pos:pos + length]
                pos += -(-length // dirty_block) * dirty_block
        if dirty is not None:
            dirty.extend((rec.offset + off, length) for off, length in spans)
        return packed2d, d2h

    def _fill(self, leaves, ready, *, track_dirty: bool, dirty_block: int,
              device_dirty: bool = False,
              progress: Optional[SnapshotProgress] = None,
              chunk_bytes: int = 0):
        if self._device is None:
            return self._fill_on(leaves, track_dirty, dirty_block,
                                 device_dirty, progress, chunk_bytes)
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self._device)
        with torch.cuda.device(self._device), torch.cuda.stream(self._stream):
            self._stream.wait_event(ready)
            return self._fill_on(leaves, track_dirty, dirty_block,
                                 device_dirty, progress, chunk_bytes)

    def _fill_on(self, leaves, track_dirty, dirty_block, device_dirty,
                 progress, chunk_bytes):
        """Copy ``leaves`` into the laid-out arena (device→host), piece
        by piece when chunked, on the current stream. Dirty compare runs
        per piece BEFORE the copy-in overwrites the resident image; spans
        never cross record boundaries (adjacent pieces of one record
        merge)."""
        from repro_torch.core.delta import dirty_byte_spans
        prev_valid = self.last_reused and self._image_valid
        self._image_valid = False
        dirty: Optional[list] = [] if (track_dirty and prev_valid) else None
        n = len(self._records)
        old_prev = (self._dev_prev
                    if (device_dirty and prev_valid
                        and self._dev_prev is not None
                        and len(self._dev_prev) == n) else None)
        new_prev: Optional[list] = [None] * n if device_dirty else None
        piece = 0
        if progress is not None and chunk_bytes > 0:
            piece = max(chunk_bytes - chunk_bytes % dirty_block,
                        dirty_block)
        inflight: collections.deque = collections.deque()

        def settle(keep: int):
            # advance the watermark past copies whose events completed,
            # oldest first, until at most ``keep`` remain in flight
            while len(inflight) > keep:
                ev, mark = inflight.popleft()
                ev.synchronize()
                if progress is not None:
                    progress.advance(mark)

        d2h = 0
        for i, ((_name, leaf), dst, rec) in enumerate(
                zip(leaves, self._buffers, self._records)):
            end = rec.offset + rec.nbytes
            if dst.size == 0:
                continue
            if old_prev is not None and old_prev[i] is not None \
                    and self._device_eligible(rec, dirty_block):
                settle(0)
                new_prev[i], nb = self._fill_record_device(
                    leaf, dst, rec, old_prev[i], dirty, dirty_block)
                old_prev[i] = None      # one packed image per record
                d2h += nb
                if progress is not None:
                    progress.advance(end)
                continue
            src = _LeafBytes(leaf)
            step = piece if piece else rec.nbytes
            if src.on_device and dirty is None:
                # straight into the pinned arena, chunk by chunk
                lo = 0
                while lo < rec.nbytes:
                    hi = min(lo + step, rec.nbytes)
                    src.copy_to(self._t8[rec.offset + lo:rec.offset + hi],
                                lo, hi)
                    ev = torch.cuda.Event()
                    ev.record()
                    inflight.append((ev, rec.offset + hi))
                    settle(_COPY_WINDOW)
                    lo = hi
            else:
                # host compare+copy (the verification oracle)
                settle(0)
                dst8 = dst.reshape(-1).view(np.uint8)
                rec_spans: list = []
                lo = 0
                while lo < rec.nbytes:
                    hi = min(lo + step, rec.nbytes)
                    pb = src.range(lo, hi)
                    if pb.size != hi - lo:
                        raise ValueError(
                            f"record {rec.name!r}: leaf yields {pb.size} "
                            f"bytes for [{lo},{hi}) of {rec.nbytes}")
                    if dirty is not None:
                        for off, length in dirty_byte_spans(
                                dst8[lo:hi], pb, dirty_block):
                            off += lo
                            if rec_spans and sum(rec_spans[-1]) == off:
                                rec_spans[-1] = (rec_spans[-1][0],
                                                 rec_spans[-1][1] + length)
                            else:
                                rec_spans.append((off, length))
                    dst8[lo:hi] = pb
                    if progress is not None:
                        progress.advance(rec.offset + hi)
                    lo = hi
                if dirty is not None:
                    dirty.extend((rec.offset + off, length)
                                 for off, length in rec_spans)
            d2h += rec.nbytes
            if device_dirty and self._device_eligible(rec, dirty_block):
                # seed the device baseline so the NEXT fill can mask
                from repro_torch.kernels import ops
                elems = dirty_block // store_dtype(rec.dtype).itemsize
                new_prev[i] = ops.pack_blocks(leaf, block=elems)
        settle(0)
        if self._device is not None:
            torch.cuda.current_stream().synchronize()
        self._dev_prev = new_prev
        self.last_dirty = dirty
        self.last_d2h_bytes = d2h
        self._image_valid = True

    def serialize(self, leaves, treedef: str, track_dirty: bool = False,
                  dirty_block: int = 4096, device_dirty: bool = False):
        """Fill the arena from ``leaves`` (``[(name, tensor), ...]``)
        and return ``(Manifest, buffers)`` with the serializer's
        contract: ``buffers[i]`` holds record *i*'s bytes (views into the
        arena). ``track_dirty`` / ``device_dirty`` as in the reference:
        spans land in ``self.last_dirty``; on a layout miss it is None
        and the caller must write a keyframe."""
        ready = self._prepare(leaves, treedef)
        with spans.span("snapshot.fill") as sp:
            self._fill(leaves, ready, track_dirty=track_dirty,
                       dirty_block=dirty_block, device_dirty=device_dirty)
            sp.nbytes = self.last_d2h_bytes
        manifest = Manifest(self._records, self._total,
                            treedef=self._treedef_str)
        return manifest, list(self._buffers)

    def begin_snapshot(self, leaves, treedef: str, chunk_bytes: int, *,
                       track_dirty: bool = False, dirty_block: int = 4096,
                       device_dirty: bool = False):
        """Chunked-snapshot entry (DESIGN.md §10): lay out the stream
        (metadata only) and return ``(manifest, buffers, progress,
        fill)`` WITHOUT copying a byte. ``fill()`` — run it on a
        snapshot worker thread — streams the device→arena copy in
        ``chunk_bytes`` pieces, advancing ``progress`` as each lands.
        ``fill`` never raises: failures land in ``progress`` and re-raise
        at every ``wait_*`` site."""
        ready = self._prepare(leaves, treedef)
        progress = SnapshotProgress(self._total, chunk_bytes)
        manifest = Manifest(self._records, self._total,
                            treedef=self._treedef_str)
        buffers = list(self._buffers)

        def fill():
            failure = None
            with spans.timed("snapshot.fill") as sp:
                try:
                    self._fill(leaves, ready, track_dirty=track_dirty,
                               dirty_block=dirty_block,
                               device_dirty=device_dirty, progress=progress,
                               chunk_bytes=chunk_bytes)
                    sp.nbytes = self.last_d2h_bytes
                except BaseException as exc:  # noqa: BLE001 — parked
                    failure = exc             # and re-raised by `progress`
            progress.seconds = sp.seconds
            if failure is None:
                progress.finish()
            else:
                progress.fail(failure)

        return manifest, buffers, progress, fill

    # ------------------------------------------------------------ intro
    @property
    def pinned(self) -> bool:
        return self._pinned

    def __repr__(self):
        return (f"SerializeArena(capacity={self.capacity}, "
                f"alloc={self.n_alloc}, layout={self.n_layout}, "
                f"reuse={self.n_reuse}, pinned={self._pinned})")
