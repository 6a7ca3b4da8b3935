"""Checkpoint serving read path (DESIGN.md §12): the hot-shard read
cache and the per-tensor remote read.

A trained checkpoint's life is mostly READS by many consumers —
inference fleets, eval jobs, restarted trainers — not the one write
FastPersist optimizes. This module is the read-distribution layer on
top of the upload/peer tiers:

  * :class:`ReadCache` — a bounded local read-through cache over the
    content-addressed object keyspace (``cas/<digest>``, DESIGN.md
    §12). Entries are keyed by DIGEST, not by step, so any two
    generations whose shard bytes dedupe share one cached copy; blocks
    are fetched with ranged ``get_to`` calls, LRU-evicted by bytes,
    and whole-object fills are CRC-verified (a mismatch quarantines
    the digest's blocks and refetches once). Concurrent readers of one
    missing block share a single in-flight download.

  * :func:`load_tensor_remote` — partial restore of ONE tensor
    straight from an object store: walk the checkpoint's global span
    index (fetched from the remote manifest), range-fetch only the
    byte spans covering that tensor (through the cache when given),
    and decode — an inference worker pulls a single embedding slice or
    expert without hydrating the checkpoint. ``engine.load_tensor(...,
    tier="remote"|"peer")`` lands here.

A copy of ``repro.core.serve``: the cache keys, block layout and
hit/miss accounting are the reference's. :func:`load_tensor_remote` returns a ``torch.Tensor`` (bf16 travels as
uint16 on the stream and is viewed back as ``torch.bfloat16``), moved to
``device`` when one is given.

Both paths ride :func:`repro_torch.core.upload.ranged_get_to`, so stores
without ranged ``get_to`` still work (full fetch + local slice) — they
just can't save wire bytes. Striped delta generations (DESIGN.md §13)
are served like any v2 generation: their per-volume payload shards
are plain CAS objects, and chain replay happens client-side after
hydration.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import torch

from repro_torch.core import layout
from repro_torch.core.upload import (ObjectStore, make_store, object_key,
                               ranged_get_to, remote_prefix,
                               select_remote_generation)


# ============================================================ read cache
@dataclass
class CacheStats:
    """Counters of one :class:`ReadCache` (cumulative)."""
    hit_bytes: int = 0          # bytes served from cached blocks
    fetched_bytes: int = 0      # bytes pulled from the store into blocks
    n_hits: int = 0             # block lookups served locally
    n_misses: int = 0           # block lookups that fetched
    shared_waits: int = 0       # lookups that joined another's fetch
    evictions: int = 0          # blocks LRU-evicted at the byte bound
    quarantined: int = 0        # digests dropped after a CRC-mismatch fill


class ReadCache:
    """Digest-keyed, block-granular, LRU-by-bytes read-through cache.

    One cached object is a directory of block files
    ``<root>/<digest>/<idx>`` (``block_bytes`` each, last one ragged).
    Block granularity is what makes PARTIAL reads cacheable: a
    per-tensor read warms exactly the blocks covering its spans, and a
    later full hydration reuses them. Because keys are content digests,
    the cache is shared across steps, generations, and peers — the
    dedup property of the ``cas/`` keyspace carries over to local disk.

    Thread-safe; concurrent readers of the same missing block share one
    in-flight download (single-flight), so a fleet of serving threads
    cannot stampede the store.

    Integrity: per-block fetches cannot be CRC-checked (the manifest
    records whole-object CRCs), so verification happens on whole-object
    assembly (:meth:`fetch_file` with ``crc``) — a mismatch quarantines
    every cached block of the digest and refetches ONCE before giving
    up, self-healing a corrupted cache without serving garbage.
    """

    def __init__(self, root: str, max_bytes: int,
                 block_bytes: int = 1 << 20):
        assert max_bytes > 0 and block_bytes > 0
        self.root = os.path.abspath(root)
        self.max_bytes = int(max_bytes)
        self.block_bytes = int(block_bytes)
        os.makedirs(self.root, exist_ok=True)
        self.stats = CacheStats()
        self._lock = threading.Lock()
        self._lru: "OrderedDict[Tuple[str, int], int]" = OrderedDict()
        self._inflight: Dict[Tuple[str, int], threading.Event] = {}
        self._bytes = 0

    # ------------------------------------------------------------- layout
    def _block_path(self, digest: str, idx: int) -> str:
        return os.path.join(self.root, digest, f"{idx:06d}")

    def _block_len(self, size: int, idx: int) -> int:
        lo = idx * self.block_bytes
        return max(0, min(self.block_bytes, size - lo))

    @property
    def cached_bytes(self) -> int:
        with self._lock:
            return self._bytes

    # ------------------------------------------------------- single block
    def _ensure_block(self, store: ObjectStore, key: str, digest: str,
                      size: int, idx: int) -> Tuple[str, bool]:
        """Path of block ``idx`` of ``digest``, fetching it (or joining
        an in-flight fetch) when absent. Returns ``(path, was_hit)``."""
        bkey = (digest, idx)
        path = self._block_path(digest, idx)
        while True:
            with self._lock:
                if bkey in self._lru:
                    self._lru.move_to_end(bkey)
                    self.stats.n_hits += 1
                    return path, True
                ev = self._inflight.get(bkey)
                if ev is None:
                    self._inflight[bkey] = threading.Event()
                    break
            # someone else is downloading this exact block — wait for
            # their result instead of issuing a duplicate fetch
            with self._lock:
                self.stats.shared_waits += 1
            ev.wait()
        try:
            bln = self._block_len(size, idx)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + f".tmp-{os.getpid()}-{threading.get_ident()}"
            try:
                ranged_get_to(store, key, tmp,
                              offset=idx * self.block_bytes, length=bln)
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            with self._lock:
                self._lru[bkey] = bln
                self._bytes += bln
                self.stats.n_misses += 1
                self.stats.fetched_bytes += bln
                self._evict_locked(keep=bkey)
            return path, False
        finally:
            with self._lock:
                ev = self._inflight.pop(bkey, None)
            if ev is not None:
                ev.set()

    def _evict_locked(self, keep=None):
        # caller holds self._lock; never evict the block just inserted
        while self._bytes > self.max_bytes and len(self._lru) > 1:
            victim = next(iter(self._lru))
            if victim == keep:
                self._lru.move_to_end(victim, last=False)
                victim = next(k for k in self._lru if k != keep)
            ln = self._lru.pop(victim)
            self._bytes -= ln
            self.stats.evictions += 1
            try:
                os.unlink(self._block_path(*victim))
            except OSError:
                pass

    def _quarantine(self, digest: str):
        """Drop every cached block of a digest whose assembled bytes
        failed CRC — they are individually unattributable, so all go."""
        with self._lock:
            victims = [k for k in self._lru if k[0] == digest]
            for k in victims:
                self._bytes -= self._lru.pop(k)
            self.stats.quarantined += 1
        shutil.rmtree(os.path.join(self.root, digest), ignore_errors=True)

    # ------------------------------------------------------------- reads
    def read(self, store: ObjectStore, key: str, digest: str, size: int,
             offset: int = 0, length: Optional[int] = None) -> bytes:
        """Bytes ``[offset, offset+length)`` of the object, through the
        cache — only the covering blocks are fetched/warmed."""
        if length is None:
            length = size - offset
        if length <= 0:
            return b""
        end = offset + length
        assert end <= size, (offset, length, size)
        out = bytearray()
        for idx in range(offset // self.block_bytes,
                         (end - 1) // self.block_bytes + 1):
            path, _ = self._ensure_block(store, key, digest, size, idx)
            blo = idx * self.block_bytes
            lo = max(offset, blo) - blo
            hi = min(end, blo + self._block_len(size, idx)) - blo
            with open(path, "rb") as f:
                f.seek(lo)
                chunk = f.read(hi - lo)
            with self._lock:
                self.stats.hit_bytes += len(chunk)
            out += chunk
        return bytes(out)

    def fetch_file(self, store: ObjectStore, key: str, digest: str,
                   size: int, dst: str, crc: Optional[int] = None,
                   readers: int = 1, io_config=None) -> Tuple[int, int]:
        """Assemble the WHOLE object into ``dst`` through the cache,
        block-parallel ``readers`` wide; verify against ``crc`` when
        given (quarantine + one refetch on mismatch). Returns
        ``(hit_bytes, fetched_bytes)`` — how much came from cache vs.
        the wire, for :class:`repro_torch.core.upload.HydrateStats`."""
        n_blocks = max(1, (size + self.block_bytes - 1) // self.block_bytes)
        for attempt in (0, 1):
            hit_bytes = fetched_bytes = 0
            hits: List[bool] = [False] * n_blocks

            def ensure(idx):
                _, was_hit = self._ensure_block(store, key, digest,
                                                size, idx)
                hits[idx] = was_hit

            if readers > 1 and n_blocks > 1:
                from concurrent.futures import ThreadPoolExecutor
                with ThreadPoolExecutor(max_workers=readers) as pool:
                    list(pool.map(ensure, range(n_blocks)))
            else:
                for idx in range(n_blocks):
                    ensure(idx)
            for idx in range(n_blocks):
                bln = self._block_len(size, idx)
                if hits[idx]:
                    hit_bytes += bln
                else:
                    fetched_bytes += bln
            tmp = dst + f".asm-{os.getpid()}-{threading.get_ident()}"
            try:
                with open(tmp, "wb") as out:
                    for idx in range(n_blocks):
                        p = self._block_path(digest, idx)
                        with open(p, "rb") as src:
                            shutil.copyfileobj(src, out, 1 << 20)
                if crc is not None:
                    from repro_torch.core.reader import file_crc32
                    got = file_crc32(tmp, os.path.getsize(tmp), io_config)
                    if got != crc or os.path.getsize(tmp) != size:
                        self._quarantine(digest)
                        if attempt == 0:
                            continue       # refetch once, then give up
                        raise IOError(
                            f"read cache: object {key} assembled crc "
                            f"{got:#x} != manifest {crc:#x} after "
                            f"refetch — store-side corruption")
                os.replace(tmp, dst)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            with self._lock:
                self.stats.hit_bytes += hit_bytes
            return hit_bytes, fetched_bytes
        raise AssertionError("unreachable")


# ===================================================== per-tensor reads
@dataclass
class TensorReadStats:
    """Wire accounting of one :func:`load_tensor_remote` call — the
    serving win is ``fetched_bytes`` tracking the TENSOR's size, not
    the checkpoint's."""
    name: str = ""
    step: int = -1
    tensor_bytes: int = 0       # the decoded tensor's payload size
    total_bytes: int = 0        # whole checkpoint's payload size
    fetched_bytes: int = 0      # bytes that crossed the wire
    cache_hit_bytes: int = 0    # bytes served from the read cache
    n_spans: int = 0
    seconds: float = 0.0


def _object_bytes(store: ObjectStore, commit: dict, prefix: str,
                  name: str, size: int, offset: int, length: int,
                  cache: Optional[ReadCache],
                  stats: TensorReadStats) -> bytes:
    """Range-read one committed object, through the cache when it is
    digest-keyed, else via a ranged fetch to a scratch file."""
    key = object_key(commit, prefix, name)
    digest = (commit.get("object_digest") or {}).get(name)
    if cache is not None and digest:
        before = (cache.stats.fetched_bytes, cache.stats.hit_bytes)
        data = cache.read(store, key, digest, size, offset, length)
        stats.fetched_bytes += cache.stats.fetched_bytes - before[0]
        stats.cache_hit_bytes += cache.stats.hit_bytes - before[1]
        return data
    import tempfile
    fd, tmp = tempfile.mkstemp(prefix="fp-serve-")
    os.close(fd)
    try:
        ranged_get_to(store, key, tmp, offset=offset, length=length)
        with open(tmp, "rb") as f:
            data = f.read()
    finally:
        os.unlink(tmp)
    stats.fetched_bytes += len(data)
    return data


def load_tensor_remote(store: Union[str, ObjectStore], name: str,
                       step: Optional[int] = None,
                       generation: Optional[str] = None,
                       cache: Optional[ReadCache] = None,
                       stats_out: Optional[list] = None,
                       device=None) -> torch.Tensor:
    """Partial restore of ONE tensor straight from an object store —
    no local checkpoint, no full hydration (DESIGN.md §12).

    Walks the remote generation's manifest + global span index exactly
    like the local :meth:`FastPersistCheckpointer.load_tensor`, but
    every byte comes from ranged object reads: the manifest object
    first, then only the ``(shard, offset, length)`` spans covering
    ``name``. With a :class:`ReadCache` the spans warm digest-keyed
    blocks shared with hydration and other tensors' reads.

    Args:
        store: object store (spec string or instance) holding committed
            ``ckpt_<step>.gen-<nonce>/`` generations — the remote tier
            or any single peer's store.
        name: tensor name as recorded in the manifest.
        step: remote step; latest committed when None.
        generation: specific remote generation nonce.
        cache: optional read cache (strongly recommended for fleets).
        stats_out: a list to append this call's
            :class:`TensorReadStats` to.
        device: where to place the tensor (``.to(device)``); None keeps
            it on the CPU.

    Raises:
        FileNotFoundError: no committed generation matches.
        KeyError: the tensor is not in the checkpoint's index.
        NotImplementedError: the generation is a delta or quantized
            (no per-tensor byte identity) — hydrate + load instead.
    """
    from repro_torch.core.serializer import TensorRecord, decode_record

    t0 = time.perf_counter()
    store = make_store(store)
    step, generation, commit = select_remote_generation(store, step,
                                                        generation)
    prefix = remote_prefix(step, generation)
    if commit.get("delta"):
        raise NotImplementedError(
            f"load_tensor on a remote delta generation (step {step}) is "
            f"not supported — delta shards hold a packed dirty-span "
            f"payload with no per-tensor index; hydrate + load(), or "
            f"point at a keyframe step")
    objects: Dict[str, int] = commit.get("objects") or {}
    mname = layout.MANIFEST_FILE
    if mname not in objects:
        raise FileNotFoundError(
            f"remote generation {prefix} carries no {mname}")
    stats = TensorReadStats(name=name, step=step)
    raw_meta = _object_bytes(store, commit, prefix, mname,
                             objects[mname], 0, objects[mname],
                             cache, stats)
    meta = json.loads(raw_meta.decode())
    if (meta.get("extras") or {}).get("quantized"):
        raise NotImplementedError(
            f"load_tensor on a quantized checkpoint (step {step}) is "
            f"not supported — dequantization needs the whole stream")
    index = meta.get("index")
    if index is None or name not in index:
        raise KeyError(
            f"tensor {name!r} not in the remote checkpoint index "
            f"(layout v1 checkpoints have no index — hydrate + load())")
    rd = next(r for r in meta["records"] if r["name"] == name)
    rec = TensorRecord(rd["name"], rd["dtype"], tuple(rd["shape"]),
                       rd["offset"], rd["nbytes"])
    stats.tensor_bytes = rec.nbytes
    stats.total_bytes = int(meta.get("total_bytes", 0))
    by_shard = {int(e["shard_index"]): e for e in meta["plan"]["extents"]}
    single = "checkpoint.bin" in objects
    raw = bytearray()
    for shard_index, off, length in index[name]:
        e = by_shard[int(shard_index)]
        if single:
            oname, ooff = "checkpoint.bin", int(e["offset"]) + off
        else:
            oname, ooff = f"shard_{int(shard_index):03d}.bin", off
        raw += _object_bytes(store, commit, prefix, oname,
                             objects[oname], ooff, length, cache, stats)
        stats.n_spans += 1
    if len(raw) != rec.nbytes:
        raise IOError(f"tensor {name!r}: remote spans cover {len(raw)} "
                      f"bytes, expected {rec.nbytes}")
    out = decode_record(rec, memoryview(raw))
    if device is not None:
        out = out.to(device)
    stats.seconds = time.perf_counter() - t0
    if stats_out is not None:
        stats_out.append(stats)
    return out
