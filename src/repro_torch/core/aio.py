"""Async I/O submission backends for the NVMe read/write paths (paper
§4.1 writes, §4.2 load-then-allgather reads; DESIGN.md §6 — the
submission layer under ``writer.write_stream`` and
``reader.read_stream``).

The paper's write engine submits pinned staging buffers to the SSD with
libaio so multiple writes are in flight per writer (deep NVMe queues);
the restore path submits reads the same way so a reader rank keeps
``queue_depth`` span reads in flight. This module provides that
submission layer behind one small interface:

    sub = make_submitter(backend, fd, queue_depth)
    ticket = sub.submit(buf, offset)       # write (queue permitting)
    ticket = sub.submit_read(buf, offset)  # read INTO buf, same queue
    sub.wait(ticket)                       # block until THAT op landed
    sub.drain()                            # block until everything landed
    sub.close()

Reads and writes share one op abstraction per backend (the opcode is a
per-ticket field, not a copy-pasted submitter): identical slot/ticket
bookkeeping, queue-depth limits, and error-drain semantics. A short
async READ is completed synchronously like a short write — except that
hitting EOF mid-span is an error (a span read past the end of a shard
means a torn file, never a retry).

Three implementations, in preference order:

  * ``io_uring`` — raw ``io_uring_setup``/``io_uring_enter`` syscalls via
    ctypes (kernel ≥ 5.1; no liburing dependency). SQ/CQ rings are
    mmap'd and driven single-threaded; every submit enters the kernel,
    so no userspace memory-ordering games are needed.
  * ``libaio``  — raw ``io_setup``/``io_submit``/``io_getevents``
    syscalls via ctypes (no libaio.so dependency; these are kernel
    syscalls). True async with O_DIRECT descriptors; with buffered
    descriptors submission degrades to synchronous inside the kernel,
    preserving identical semantics.
  * ``pwrite``  — a small thread pool issuing ``os.pwrite`` (the GIL is
    released, so ``queue_depth`` writes proceed in parallel). Always
    available; the transparent fallback for tmpfs/CI/old kernels.

Capability probing is a real end-to-end self-test (write a pattern
through the candidate backend at queue depth 2, then read it back
THROUGH THE SAME BACKEND's read ops, verify both directions), run once
per process and cached — a kernel that exposes the syscalls but mangles
the ABI degrades to ``pwrite`` instead of corrupting checkpoints, and a
backend whose reads are broken is unavailable for restores too. Selection: ``$FASTPERSIST_IO_BACKEND`` overrides the
configured name; ``"auto"`` picks the first available of
io_uring > libaio > pwrite.
"""
from __future__ import annotations

import ctypes
import os
import platform
import struct
import tempfile
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

BACKENDS = ("io_uring", "libaio", "pwrite")

_ENV = "FASTPERSIST_IO_BACKEND"

# x86_64 / aarch64 syscall numbers; other arches fail the probe and
# fall back to pwrite.
_SYSCALLS = {
    "x86_64": {"io_setup": 206, "io_destroy": 207, "io_getevents": 208,
               "io_submit": 209, "io_uring_setup": 425,
               "io_uring_enter": 426},
    "aarch64": {"io_setup": 0, "io_destroy": 1, "io_submit": 2,
                "io_getevents": 4, "io_uring_setup": 425,
                "io_uring_enter": 426},
}


def _libc():
    libc = ctypes.CDLL(None, use_errno=True)
    libc.syscall.restype = ctypes.c_long
    return libc


def _sysno(name: str) -> int:
    table = _SYSCALLS.get(platform.machine())
    if table is None or name not in table:
        raise OSError(f"no syscall table for {platform.machine()}")
    return table[name]


def _buf_address(buf: memoryview) -> int:
    """Address of the first byte of a writable contiguous buffer. The
    returned ctypes object also pins ``buf`` against release."""
    c = ctypes.c_char.from_buffer(buf)
    return ctypes.addressof(c), c


class SubmitError(OSError):
    pass


# ============================================================== pwrite
class PwriteSubmitter:
    """Thread-pool pwrite/pread backend: ``queue_depth`` concurrent ops
    (os.pwrite/os.preadv release the GIL → kernel-level parallelism).
    With ``inline=True`` submit() performs the op in the calling thread —
    the genuinely synchronous single-buffer mode."""

    name = "pwrite"

    def __init__(self, fd: int, queue_depth: int = 2, inline: bool = False):
        self.fd = fd
        self._inline = inline
        self._pool = (None if inline else
                      ThreadPoolExecutor(max_workers=max(1, queue_depth),
                                         thread_name_prefix="fp-pwrite"))
        self._outstanding: List = []
        self._lock = threading.Lock()
        self.flush_seconds = 0.0
        self.n_writes = 0
        self.n_reads = 0

    def _rw(self, buf: memoryview, offset: int, read: bool):
        t0 = time.perf_counter()
        done = 0
        while done < len(buf):
            if read:
                n = os.preadv(self.fd, [buf[done:]], offset + done)
                if n == 0:
                    raise SubmitError(
                        0, f"short read: EOF at offset {offset + done} "
                           f"({done}/{len(buf)} bytes)")
            else:
                n = os.pwrite(self.fd, buf[done:], offset + done)
            done += n
        with self._lock:
            self.flush_seconds += time.perf_counter() - t0
            if read:
                self.n_reads += 1
            else:
                self.n_writes += 1

    def _submit_op(self, buf: memoryview, offset: int, read: bool):
        if self._inline:
            self._rw(buf, offset, read)
            return None
        fut = self._pool.submit(self._rw, buf, offset, read)
        self._outstanding.append(fut)
        return fut

    def submit(self, buf: memoryview, offset: int):
        return self._submit_op(buf, offset, read=False)

    def submit_read(self, buf: memoryview, offset: int):
        return self._submit_op(buf, offset, read=True)

    def wait(self, ticket):
        if ticket is not None:
            ticket.result()
            if ticket in self._outstanding:
                self._outstanding.remove(ticket)

    def drain(self):
        outstanding, self._outstanding = self._outstanding, []
        for fut in outstanding:
            fut.result()

    def close(self):
        try:
            self.drain()
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True)


# ============================================= kernel-queue submitters
class _KernelQueueSubmitter:
    """Slot/ticket bookkeeping and completion semantics shared by the
    libaio and io_uring submitters, for BOTH directions: the op (read
    or write) is a per-ticket field, so subclasses implement one
    ``_submit_op(buf, offset, read)`` plus ``_reap_events(min_nr) ->
    [(ticket, res)]`` (consume ALL currently available events) and
    ``close``."""

    def __init__(self, fd: int, queue_depth: int):
        self.fd = fd
        self._depth = max(1, queue_depth)
        self._free = list(range(self._depth))
        self._inflight: Dict[int, tuple] = {}  # ticket → (slot, buf, pin,
        #                                          nbytes, offset, read)
        self._done: set = set()
        self._seq = 0
        self.flush_seconds = 0.0
        self.n_writes = 0
        self.n_reads = 0

    def _acquire_slot(self) -> int:
        if not self._free:
            t0 = time.perf_counter()
            self._reap(min_nr=1)
            self.flush_seconds += time.perf_counter() - t0
        return self._free.pop()

    def _track(self, ticket: int, slot: int, buf, pin, nbytes: int,
               offset: int, read: bool = False):
        self._inflight[ticket] = (slot, buf, pin, nbytes, offset, read)

    def _finish_tail(self, buf, nbytes: int, offset: int, done: int,
                     read: bool):
        """Complete a short async op synchronously — identical
        bytes-on-disk/in-buffer semantics, just slower. A READ that hits
        EOF mid-span is an error (torn shard), never a busy-loop."""
        while done < nbytes:
            if read:
                n = os.preadv(self.fd, [buf[done:]], offset + done)
                if n == 0:
                    raise SubmitError(
                        0, f"short read: EOF at offset {offset + done} "
                           f"({done}/{nbytes} bytes)")
            else:
                n = os.pwrite(self.fd, buf[done:], offset + done)
            done += n

    def _reap(self, min_nr: int):
        """Consume a completion batch. The WHOLE batch is processed —
        slots freed, tickets resolved — before any error is raised;
        raising mid-batch would strand already-consumed events in
        ``_inflight`` and turn a disk error into a drain() hang."""
        errors: List[BaseException] = []
        for ticket, res in self._reap_events(min_nr):
            slot, buf, _pin, nbytes, offset, read = \
                self._inflight.pop(ticket)
            self._free.append(slot)
            if res < 0:
                errors.append(SubmitError(-res, os.strerror(-res)))
                continue
            if res < nbytes:
                try:
                    self._finish_tail(buf, nbytes, offset, res, read)
                except OSError as e:
                    errors.append(e)
                    continue
            self._done.add(ticket)
            if read:
                self.n_reads += 1
            else:
                self.n_writes += 1
        if errors:
            raise errors[0]

    def _reap_events(self, min_nr: int):
        raise NotImplementedError

    def _submit_op(self, buf: memoryview, offset: int, read: bool):
        raise NotImplementedError

    def submit(self, buf: memoryview, offset: int):
        return self._submit_op(buf, offset, read=False)

    def submit_read(self, buf: memoryview, offset: int):
        return self._submit_op(buf, offset, read=True)

    def wait(self, ticket):
        t0 = time.perf_counter()
        while ticket not in self._done:
            if ticket not in self._inflight:
                # resolved by an earlier reap that raised its error
                raise SubmitError(0, f"write {ticket} failed earlier")
            self._reap(min_nr=1)
        self._done.discard(ticket)
        self.flush_seconds += time.perf_counter() - t0

    def drain(self):
        t0 = time.perf_counter()
        while self._inflight:
            self._reap(min_nr=1)
        self._done.clear()
        self.flush_seconds += time.perf_counter() - t0


# ============================================================== libaio
# struct iocb / io_event per linux/aio_abi.h (little-endian layout)
class _Iocb(ctypes.Structure):
    _fields_ = [("aio_data", ctypes.c_uint64),
                ("aio_key", ctypes.c_uint32),
                ("aio_rw_flags", ctypes.c_uint32),
                ("aio_lio_opcode", ctypes.c_uint16),
                ("aio_reqprio", ctypes.c_int16),
                ("aio_fildes", ctypes.c_uint32),
                ("aio_buf", ctypes.c_uint64),
                ("aio_nbytes", ctypes.c_uint64),
                ("aio_offset", ctypes.c_int64),
                ("aio_reserved2", ctypes.c_uint64),
                ("aio_flags", ctypes.c_uint32),
                ("aio_resfd", ctypes.c_uint32)]


class _IoEvent(ctypes.Structure):
    _fields_ = [("data", ctypes.c_uint64),
                ("obj", ctypes.c_uint64),
                ("res", ctypes.c_int64),
                ("res2", ctypes.c_int64)]


_IOCB_CMD_PREAD = 0
_IOCB_CMD_PWRITE = 1


class LibaioSubmitter(_KernelQueueSubmitter):
    """Kernel AIO (io_submit/io_getevents) driven through raw syscalls.
    One iocb slot per queue-depth unit; completions are reaped lazily
    when the queue is full or a caller waits. Reads and writes share
    the context — only the iocb opcode differs."""

    name = "libaio"

    def __init__(self, fd: int, queue_depth: int = 2):
        super().__init__(fd, queue_depth)
        self._libc = _libc()
        self._ctx = ctypes.c_ulong(0)
        r = self._libc.syscall(_sysno("io_setup"),
                               ctypes.c_uint(self._depth),
                               ctypes.byref(self._ctx))
        if r != 0:
            raise SubmitError(ctypes.get_errno(), "io_setup failed")
        self._iocbs = (_Iocb * self._depth)()
        self._events = (_IoEvent * self._depth)()

    def _submit_op(self, buf: memoryview, offset: int, read: bool):
        slot = self._acquire_slot()
        self._seq += 1
        ticket = self._seq
        addr, pin = _buf_address(buf)
        cb = self._iocbs[slot]
        ctypes.memset(ctypes.byref(cb), 0, ctypes.sizeof(cb))
        cb.aio_data = ticket
        cb.aio_lio_opcode = _IOCB_CMD_PREAD if read else _IOCB_CMD_PWRITE
        cb.aio_fildes = self.fd
        cb.aio_buf = addr
        cb.aio_nbytes = len(buf)
        cb.aio_offset = offset
        ptr = ctypes.pointer(ctypes.pointer(cb))
        r = self._libc.syscall(_sysno("io_submit"), self._ctx,
                               ctypes.c_long(1), ptr)
        if r != 1:
            self._free.append(slot)
            raise SubmitError(ctypes.get_errno(),
                              f"io_submit returned {r}")
        self._track(ticket, slot, buf, pin, len(buf), offset, read)
        return ticket

    def _reap_events(self, min_nr: int):
        r = self._libc.syscall(_sysno("io_getevents"), self._ctx,
                               ctypes.c_long(min_nr),
                               ctypes.c_long(self._depth),
                               ctypes.byref(self._events), None)
        if r < 0:
            raise SubmitError(ctypes.get_errno(), "io_getevents failed")
        return [(int(self._events[i].data), int(self._events[i].res))
                for i in range(r)]

    def close(self):
        try:
            self.drain()
        finally:
            self._libc.syscall(_sysno("io_destroy"), self._ctx)
            self._ctx = ctypes.c_ulong(0)


# ============================================================ io_uring
class _SqringOffsets(ctypes.Structure):
    _fields_ = [("head", ctypes.c_uint32), ("tail", ctypes.c_uint32),
                ("ring_mask", ctypes.c_uint32),
                ("ring_entries", ctypes.c_uint32),
                ("flags", ctypes.c_uint32), ("dropped", ctypes.c_uint32),
                ("array", ctypes.c_uint32), ("resv1", ctypes.c_uint32),
                ("user_addr", ctypes.c_uint64)]


class _CqringOffsets(ctypes.Structure):
    _fields_ = [("head", ctypes.c_uint32), ("tail", ctypes.c_uint32),
                ("ring_mask", ctypes.c_uint32),
                ("ring_entries", ctypes.c_uint32),
                ("overflow", ctypes.c_uint32), ("cqes", ctypes.c_uint32),
                ("flags", ctypes.c_uint32), ("resv1", ctypes.c_uint32),
                ("user_addr", ctypes.c_uint64)]


class _IoUringParams(ctypes.Structure):
    _fields_ = [("sq_entries", ctypes.c_uint32),
                ("cq_entries", ctypes.c_uint32),
                ("flags", ctypes.c_uint32),
                ("sq_thread_cpu", ctypes.c_uint32),
                ("sq_thread_idle", ctypes.c_uint32),
                ("features", ctypes.c_uint32),
                ("wq_fd", ctypes.c_uint32),
                ("resv", ctypes.c_uint32 * 3),
                ("sq_off", _SqringOffsets),
                ("cq_off", _CqringOffsets)]


class _Iovec(ctypes.Structure):
    _fields_ = [("iov_base", ctypes.c_void_p), ("iov_len", ctypes.c_size_t)]


_IORING_OP_READV = 1             # supported since the first io_uring kernel
_IORING_OP_WRITEV = 2
_IORING_ENTER_GETEVENTS = 1
_IORING_FEAT_SINGLE_MMAP = 1
_IORING_OFF_SQ_RING = 0
_IORING_OFF_CQ_RING = 0x8000000
_IORING_OFF_SQES = 0x10000000
_SQE_SIZE = 64
_CQE_SIZE = 16


class IoUringSubmitter(_KernelQueueSubmitter):
    """io_uring via raw syscalls + mmap'd rings (no liburing). Single
    threaded; every submit calls io_uring_enter, so the syscall itself
    orders our ring updates against the kernel on every architecture."""

    name = "io_uring"

    def __init__(self, fd: int, queue_depth: int = 2):
        import mmap

        super().__init__(fd, queue_depth)
        self._libc = _libc()
        entries = 1
        while entries < self._depth:
            entries <<= 1
        params = _IoUringParams()
        ring_fd = self._libc.syscall(_sysno("io_uring_setup"),
                                     ctypes.c_uint(entries),
                                     ctypes.byref(params))
        if ring_fd < 0:
            raise SubmitError(ctypes.get_errno(), "io_uring_setup failed")
        self._ring_fd = int(ring_fd)
        self._sq_entries = params.sq_entries
        self._cq_entries = params.cq_entries
        sq_sz = params.sq_off.array + params.sq_entries * 4
        cq_sz = params.cq_off.cqes + params.cq_entries * _CQE_SIZE
        flags = mmap.MAP_SHARED | getattr(mmap, "MAP_POPULATE", 0)
        prot = mmap.PROT_READ | mmap.PROT_WRITE
        if params.features & _IORING_FEAT_SINGLE_MMAP:
            sz = max(sq_sz, cq_sz)
            self._sq_mm = mmap.mmap(self._ring_fd, sz, flags=flags,
                                    prot=prot, offset=_IORING_OFF_SQ_RING)
            self._cq_mm = self._sq_mm
        else:
            self._sq_mm = mmap.mmap(self._ring_fd, sq_sz, flags=flags,
                                    prot=prot, offset=_IORING_OFF_SQ_RING)
            self._cq_mm = mmap.mmap(self._ring_fd, cq_sz, flags=flags,
                                    prot=prot, offset=_IORING_OFF_CQ_RING)
        self._sqes_mm = mmap.mmap(self._ring_fd,
                                  params.sq_entries * _SQE_SIZE,
                                  flags=flags, prot=prot,
                                  offset=_IORING_OFF_SQES)
        o = params.sq_off
        self._sq_tail_off, self._sq_mask, self._sq_array_off = \
            o.tail, self._u32(self._sq_mm, o.ring_mask), o.array
        c = params.cq_off
        self._cq_head_off, self._cq_tail_off = c.head, c.tail
        self._cq_mask = self._u32(self._cq_mm, c.ring_mask)
        self._cqes_off = c.cqes
        self._sq_tail = self._u32(self._sq_mm, o.tail)
        self._iov = (_Iovec * self._sq_entries)()
        # the ring may round queue_depth up to a power of two — use
        # every slot the kernel gave us
        self._free = list(range(self._sq_entries))

    @staticmethod
    def _u32(mm, off) -> int:
        return struct.unpack_from("<I", mm, off)[0]

    @staticmethod
    def _put_u32(mm, off, val):
        struct.pack_into("<I", mm, off, val & 0xFFFFFFFF)

    def _enter(self, to_submit: int, min_complete: int, flags: int) -> int:
        r = self._libc.syscall(_sysno("io_uring_enter"),
                               ctypes.c_uint(self._ring_fd),
                               ctypes.c_uint(to_submit),
                               ctypes.c_uint(min_complete),
                               ctypes.c_uint(flags), None,
                               ctypes.c_size_t(0))
        if r < 0:
            raise SubmitError(ctypes.get_errno(), "io_uring_enter failed")
        return int(r)

    def _submit_op(self, buf: memoryview, offset: int, read: bool):
        slot = self._acquire_slot()
        self._seq += 1
        ticket = self._seq
        addr, pin = _buf_address(buf)
        self._iov[slot].iov_base = addr
        self._iov[slot].iov_len = len(buf)
        idx = self._sq_tail & self._sq_mask
        # sqe: opcode u8, flags u8, ioprio u16, fd s32, off u64, addr u64,
        #      len u32, rw_flags u32, user_data u64, pad[24]
        opcode = _IORING_OP_READV if read else _IORING_OP_WRITEV
        struct.pack_into("<BBHiQQIIQ", self._sqes_mm, idx * _SQE_SIZE,
                         opcode, 0, 0, self.fd, offset,
                         ctypes.addressof(self._iov[slot]), 1, 0, ticket)
        self._sqes_mm[idx * _SQE_SIZE + 40:(idx + 1) * _SQE_SIZE] = \
            b"\x00" * 24
        self._put_u32(self._sq_mm, self._sq_array_off + 4 * idx, idx)
        self._sq_tail += 1
        self._put_u32(self._sq_mm, self._sq_tail_off, self._sq_tail)
        submitted = self._enter(1, 0, 0)
        if submitted != 1:
            self._free.append(slot)
            raise SubmitError(0, f"io_uring_enter submitted {submitted}")
        self._track(ticket, slot, buf, pin, len(buf), offset, read)
        return ticket

    def _reap_events(self, min_nr: int):
        if min_nr and self._inflight:
            self._enter(0, min_nr, _IORING_ENTER_GETEVENTS)
        events = []
        head = self._u32(self._cq_mm, self._cq_head_off)
        tail = self._u32(self._cq_mm, self._cq_tail_off)
        while head != tail:
            idx = head & self._cq_mask
            user_data, res, _flags = struct.unpack_from(
                "<QiI", self._cq_mm, self._cqes_off + idx * _CQE_SIZE)
            head += 1
            self._put_u32(self._cq_mm, self._cq_head_off, head)
            events.append((int(user_data), int(res)))
        return events

    def close(self):
        try:
            self.drain()
        finally:
            for mm in {id(self._sqes_mm): self._sqes_mm,
                       id(self._sq_mm): self._sq_mm,
                       id(self._cq_mm): self._cq_mm}.values():
                try:
                    mm.close()
                except (BufferError, ValueError):   # pragma: no cover
                    pass
            os.close(self._ring_fd)


# =========================================================== selection
_FACTORIES = {
    "pwrite": PwriteSubmitter,
    "libaio": LibaioSubmitter,
    "io_uring": IoUringSubmitter,
}

_probe_cache: Dict[str, bool] = {}
_probe_lock = threading.Lock()
_warned: set = set()


def _probe(name: str) -> bool:
    """End-to-end self-test in BOTH directions: push two known chunks
    through the backend at queue depth 2, verify the file contents,
    then read them back through the backend's read ops and verify
    again. Any failure — missing syscalls, ABI mismatch, seccomp —
    means 'unavailable' (for saves and restores alike)."""
    path = None
    fd = -1
    try:
        fdt, path = tempfile.mkstemp(prefix=f"fp_{name}_probe_")
        os.close(fdt)
        fd = os.open(path, os.O_WRONLY)
        sub = _FACTORIES[name](fd, 2)
        try:
            a = memoryview(bytearray(b"\xa5" * 4096))
            b = memoryview(bytearray(b"\x5a" * 512))
            t1 = sub.submit(a, 0)
            t2 = sub.submit(b, 4096)
            sub.wait(t1)
            sub.wait(t2)
            sub.drain()
        finally:
            sub.close()
        os.close(fd)
        fd = -1
        with open(path, "rb") as f:
            data = f.read()
        if data != b"\xa5" * 4096 + b"\x5a" * 512:
            return False
        # read direction: same ops, same queue, into fresh buffers
        fd = os.open(path, os.O_RDONLY)
        ra = memoryview(bytearray(4096))
        rb = memoryview(bytearray(512))
        sub = _FACTORIES[name](fd, 2)
        try:
            t1 = sub.submit_read(ra, 0)
            t2 = sub.submit_read(rb, 4096)
            sub.wait(t1)
            sub.wait(t2)
            sub.drain()
        finally:
            sub.close()
        os.close(fd)
        fd = -1
        return bytes(ra) == b"\xa5" * 4096 and bytes(rb) == b"\x5a" * 512
    except Exception:
        return False
    finally:
        if fd >= 0:
            try:
                os.close(fd)
            except OSError:     # pragma: no cover
                pass
        if path is not None:
            try:
                os.remove(path)
            except OSError:     # pragma: no cover
                pass


def backend_available(name: str) -> bool:
    """Is ``name`` usable on this kernel/filesystem? Probed once per
    process (pwrite is always available)."""
    if name == "pwrite":
        return True
    if name not in _FACTORIES:
        raise ValueError(f"unknown io backend {name!r}; "
                         f"choose from {BACKENDS}")
    with _probe_lock:
        if name not in _probe_cache:
            _probe_cache[name] = _probe(name)
        return _probe_cache[name]


def resolve_backend(requested: str = "auto") -> str:
    """Map a requested backend name (or "auto") to an AVAILABLE one.
    ``$FASTPERSIST_IO_BACKEND`` overrides ``requested``; an explicitly
    requested but unavailable async backend falls back to ``pwrite``
    with a one-time warning (identical semantics, CI-transparent)."""
    env = os.environ.get(_ENV, "").strip()
    name = env or requested or "auto"
    if name == "auto":
        for cand in ("io_uring", "libaio"):
            if backend_available(cand):
                return cand
        return "pwrite"
    if name == "pwrite":
        return "pwrite"
    if name not in _FACTORIES:
        raise ValueError(f"unknown io backend {name!r}; "
                         f"choose from {BACKENDS} or 'auto'")
    if backend_available(name):
        return name
    if name not in _warned:
        _warned.add(name)
        warnings.warn(f"io backend {name!r} unavailable on this "
                      f"kernel/filesystem; falling back to 'pwrite'",
                      stacklevel=2)
    return "pwrite"


def make_submitter(backend: str, fd: int, queue_depth: int,
                   inline: bool = False):
    """Construct a submitter for an ALREADY-RESOLVED backend name.
    ``inline`` (pwrite only) makes submit() fully synchronous — the
    single-buffer mode measured by fig7's 1-buffer datapoint."""
    if backend == "pwrite":
        return PwriteSubmitter(fd, queue_depth, inline=inline)
    return _FACTORIES[backend](fd, queue_depth)
