"""Tiered durability: streaming shard upload to object storage
(DESIGN.md §8; after Check-N-Run's decoupled persist and
DataStates-LLM's lazy asynchronous flush tier).

Local NVMe gets checkpoints committed fast (the paper's thesis); this
module adds the SECOND durability tier behind it: after the local
crash-atomic COMMIT rename, an :class:`UploadManager` background
worker streams every sealed shard file of the generation to an object
store, then writes a remote ``COMMIT`` object — carrying the same
per-shard ``(volume, size, crc32)`` manifest as the layout-v2 local
marker — only after every shard has landed. The training hot path
never waits on the wide-area tier:

    spec   = CheckpointSpec(directory=..., backend="fastpersist-tiered",
                            upload_store="/mnt/bucket")      # or s3://…
    handle = engine.save(state, step)        # local commit, as before
    handle.wait()                            # local durability point
    handle.wait_uploaded()                   # remote durability point
    state, m = engine.load(tier="remote")    # hydrate + restore

Crash atomicity, remote side: a remote generation is OBSERVABLE only
through its ``COMMIT`` object, which is uploaded strictly last — a
crash (or lost worker) between the local and remote commits leaves
only unreferenced payload objects that a retry overwrites in place.

Idempotent retries: the remote generation id is DERIVED from the local
COMMIT marker's content (not drawn fresh per attempt), reusing the
generation-dir nonce naming of the local sharded layout
(``ckpt_<step>.gen-<nonce>/``). Re-enqueueing the same committed step
maps to the same keys, so objects that already landed (same key, same
size) are skipped, never duplicated, and a half-uploaded generation
heals instead of leaking a second copy.

Shard enumeration rides the local COMMIT's ``shards`` list
(:func:`repro_torch.core.layout.commit_files`), so striped delta generations
(DESIGN.md §13) ship, dedupe (§12 CAS digests), and hydrate with no
special casing — a delta's per-volume payload shards are just more
entries in the same manifest.

Restore hydration: :func:`hydrate` rebuilds a local checkpoint from a
remote generation through the SAME local commit protocol (staging dir
→ local COMMIT → atomic publish), verifying every downloaded shard
against the remote manifest's CRC32 via the async span reader
(:func:`repro_torch.core.reader.read_stream`) and reusing local shard files
that still verify, so only missing/corrupted bytes cross the wire.

The :class:`ObjectStore` protocol ships with a local-filesystem "mock
bucket" (:class:`LocalObjectStore`) for tests/CI; real stores (S3,
GCS, ...) plug in via :func:`register_store_scheme` without touching
the engine.

A copy of ``repro.core.upload``: object keys, ``cas/<crc32>-<size>``
digests, remote generation nonces and the remote COMMIT (written last)
are the reference's byte for byte, so a generation either package
uploads hydrates through the other.
"""
from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple, Union)

from repro_torch.core import layout, retry

#: remote marker object name; a generation without it is unobservable
REMOTE_COMMIT = "COMMIT"

_GEN_RE = re.compile(r"^ckpt_(\d+)\.gen-([0-9a-f]+)$")


# ============================================================ ObjectStore
class ObjectStore:
    """Minimal object-store surface the upload tier needs. Keys are
    ``/``-separated strings; ``put``/``put_file`` must be ATOMIC per
    object (a reader never observes a torn object) and overwrite in
    place — both are what real stores (S3/GCS) give you for free."""

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def put_file(self, key: str, path: str) -> None:
        """Upload one local file. Default reads it whole; stores with a
        streaming/multipart path should override."""
        with open(path, "rb") as f:
            self.put(key, f.read())

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def get_to(self, key: str, path: str, offset: int = 0,
               length: Optional[int] = None) -> None:
        """Download object bytes ``[offset, offset+length)`` to a local
        path (``length=None`` → through the end; the default call is the
        whole object). ``path`` receives EXACTLY the requested range —
        a ranged S3/GCS ``GET`` maps 1:1. Default materialises via
        :meth:`get`; streaming stores should override. Out-of-tree
        stores written against the old 2-arg signature keep working
        through :func:`ranged_get_to`'s compatibility shim."""
        data = self.get(key)
        if offset or length is not None:
            end = None if length is None else offset + length
            data = data[offset:end]
        with open(path, "wb") as f:
            f.write(data)

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def size(self, key: str) -> Optional[int]:
        """Object size in bytes, or None when absent."""
        raise NotImplementedError

    def list(self, prefix: str = "") -> List[str]:
        """Sorted keys under ``prefix``."""
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError


class LocalObjectStore(ObjectStore):
    """Filesystem-backed mock bucket (tests/CI, or an NFS/second-mount
    tier in anger). One file per object under ``root``; puts stage to a
    dot-tmp name and ``os.replace`` into place, so a killed uploader
    never leaves a torn but visible object — the same publish rule as
    the local checkpoint layout."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        p = os.path.normpath(os.path.join(self.root, key))
        if not p.startswith(self.root + os.sep):
            raise ValueError(f"object key escapes the bucket: {key!r}")
        return p

    def _publish(self, tmp: str, final: str):
        os.replace(tmp, final)

    def put(self, key: str, data: bytes) -> None:
        final = self._path(key)
        os.makedirs(os.path.dirname(final), exist_ok=True)
        tmp = final + f".tmp-{os.getpid()}-{threading.get_ident()}"
        try:
            with open(tmp, "wb") as f:
                f.write(data)
            self._publish(tmp, final)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def put_file(self, key: str, path: str) -> None:
        final = self._path(key)
        os.makedirs(os.path.dirname(final), exist_ok=True)
        tmp = final + f".tmp-{os.getpid()}-{threading.get_ident()}"
        try:
            shutil.copyfile(path, tmp)
            self._publish(tmp, final)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def get(self, key: str) -> bytes:
        with open(self._path(key), "rb") as f:
            return f.read()

    def get_to(self, key: str, path: str, offset: int = 0,
               length: Optional[int] = None) -> None:
        src = self._path(key)
        if not offset and length is None:
            shutil.copyfile(src, path)
            return
        with open(src, "rb") as f:
            f.seek(offset)
            remaining = (os.path.getsize(src) - offset if length is None
                         else length)
            with open(path, "wb") as out:
                while remaining > 0:
                    chunk = f.read(min(remaining, 1 << 20))
                    if not chunk:
                        break
                    out.write(chunk)
                    remaining -= len(chunk)

    def exists(self, key: str) -> bool:
        return os.path.isfile(self._path(key))

    def size(self, key: str) -> Optional[int]:
        try:
            return os.path.getsize(self._path(key))
        except OSError:
            return None

    def list(self, prefix: str = "") -> List[str]:
        out = []
        for dirpath, _dirs, names in os.walk(self.root):
            for n in names:
                rel = os.path.relpath(os.path.join(dirpath, n), self.root)
                key = rel.replace(os.sep, "/")
                if key.startswith(prefix) and ".tmp-" not in key:
                    out.append(key)
        return sorted(out)

    def delete(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except FileNotFoundError:
            pass


_STORE_SCHEMES: Dict[str, Callable[[str], ObjectStore]] = {}


def register_store_scheme(scheme: str,
                          factory: Callable[[str], ObjectStore],
                          overwrite: bool = False):
    """Plug a real object store in under a URL scheme.

    Args:
        scheme: the URL scheme (``"s3"``, ``"gs"``, ...), matched
            against ``<scheme>://...`` specs in :func:`make_store`.
        factory: called with the FULL spec string, returns an
            :class:`ObjectStore`.
        overwrite: replace an existing registration instead of raising.
    """
    if scheme in _STORE_SCHEMES and not overwrite:
        raise ValueError(f"store scheme {scheme!r} already registered "
                         f"(pass overwrite=True to replace)")
    _STORE_SCHEMES[scheme] = factory


def make_store(spec: Union[str, ObjectStore]) -> ObjectStore:
    """Resolve a store spec: an :class:`ObjectStore` passes through; a
    ``file://`` URL or a plain path builds a :class:`LocalObjectStore`;
    any other ``scheme://`` dispatches to :func:`register_store_scheme`
    registrations and raises a descriptive error when none matches."""
    if isinstance(spec, ObjectStore):
        return spec
    if not isinstance(spec, str):
        raise TypeError(f"upload store spec must be a path/URL or an "
                        f"ObjectStore, got {type(spec).__name__}")
    if "://" in spec:
        scheme = spec.split("://", 1)[0]
        if scheme == "file":
            return LocalObjectStore(spec.split("://", 1)[1])
        if scheme in _STORE_SCHEMES:
            return _STORE_SCHEMES[scheme](spec)
        raise KeyError(
            f"no object store registered for scheme {scheme!r} "
            f"(register one with repro_torch.core.upload.register_store_scheme; "
            f"known: file, {', '.join(sorted(_STORE_SCHEMES)) or '<none>'})")
    return LocalObjectStore(spec)


def supports_ranged_get(store: ObjectStore) -> bool:
    """Does this store's ``get_to`` accept ``offset``/``length``?
    Out-of-tree stores (and monkeypatched test doubles) written against
    the pre-serving 2-arg signature answer False and fall back to
    full-object fetch + local slice in :func:`ranged_get_to`."""
    import inspect
    fn = getattr(store, "get_to", None)
    if fn is None:
        return False
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False
    if any(p.kind == inspect.Parameter.VAR_KEYWORD
           for p in params.values()):
        return True
    return "offset" in params and "length" in params


def ranged_get_to(store: ObjectStore, key: str, path: str,
                  offset: int = 0, length: Optional[int] = None) -> None:
    """Ranged download with a legacy-store compatibility shim: stores
    whose ``get_to`` lacks the ranged signature get the WHOLE object
    fetched to a scratch file and the requested range sliced out
    locally — correct everywhere, merely unable to save wire bytes."""
    if not offset and length is None:
        store.get_to(key, path)          # 2-arg call works on every store
        return
    if supports_ranged_get(store):
        store.get_to(key, path, offset=offset, length=length)
        return
    tmp = path + f".full-{os.getpid()}-{threading.get_ident()}"
    try:
        store.get_to(key, tmp)
        with open(tmp, "rb") as f:
            f.seek(offset)
            data = f.read() if length is None else f.read(length)
        with open(path, "wb") as out:
            out.write(data)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


# ============================================== content-addressed index
#: keyspace prefix of content-addressed payload objects (DESIGN.md §12)
CAS_PREFIX = "cas"


def entry_digest(entry: dict) -> str:
    """Content digest of one :func:`layout.commit_files` entry — the
    per-shard CRC32 + size every COMMIT already records, rendered as
    ``<crc32:08x>-<size:x>``. Two shards with equal digests carry equal
    bytes (to CRC32 confidence), so the store keeps ONE copy."""
    return f"{int(entry['crc32']) & 0xFFFFFFFF:08x}-{int(entry['size']):x}"


def cas_key(digest: str) -> str:
    """Object-store key of one content-addressed payload blob."""
    return f"{CAS_PREFIX}/{digest}"


def object_key(commit: dict, prefix: str, name: str) -> str:
    """Resolve the store key holding one object of a committed
    generation: digest-keyed (``cas/<digest>``) when the COMMIT carries
    an ``object_digest`` map (DESIGN.md §12), else the legacy
    ``<prefix>/<name>`` layout of pre-serving uploads."""
    digest = (commit.get("object_digest") or {}).get(name)
    return cas_key(digest) if digest else f"{prefix}/{name}"


def referenced_digests(store: ObjectStore) -> set:
    """Digests referenced by ANY committed generation on ``store`` —
    the live set of the content-addressed keyspace. An object in
    ``cas/`` outside this set is garbage (its last referencing COMMIT
    was pruned, or its uploader died pre-COMMIT)."""
    refs: set = set()
    for s, g in remote_generations(store):
        try:
            c = read_remote_commit(store, s, g)
        except Exception:
            continue
        refs.update((c.get("object_digest") or {}).values())
    return refs


def collect_cas_orphans(store: ObjectStore) -> List[str]:
    """Refcount sweep of the content-addressed keyspace: delete every
    ``cas/`` object no surviving COMMIT references, and ONLY those —
    a digest shared by several steps/generations outlives any one of
    them. Must run where uploads of this store serialize (the tier's
    worker thread), so a payload landing for an in-flight COMMIT is
    never swept between its put and its commit point. Returns the
    deleted keys."""
    refs = referenced_digests(store)
    removed = []
    for key in store.list(CAS_PREFIX + "/"):
        digest = key[len(CAS_PREFIX) + 1:]
        if digest and digest not in refs:
            store.delete(key)
            removed.append(key)
    return removed


# ======================================================== remote layout
def remote_generation(marker: dict) -> str:
    """Deterministic generation nonce for one LOCAL commit: the CRC32
    of the canonicalised COMMIT marker. Deriving it from content (not
    ``urandom``) is what makes retries idempotent — every re-upload of
    the same committed generation maps to the same remote keys."""
    blob = json.dumps(marker, sort_keys=True).encode()
    return f"{zlib.crc32(blob) & 0xFFFFFFFF:08x}"


def remote_prefix(step: int, generation: str) -> str:
    """Key prefix of one remote generation — the object-store analogue
    of the local ``ckpt_<step>.shards-<nonce>`` generation dirs."""
    return f"{layout.step_dir_name(step)}.gen-{generation}"


def parse_remote_prefix(prefix: str) -> Optional[Tuple[int, str]]:
    """(step, generation) of a remote generation prefix, else None."""
    m = _GEN_RE.match(prefix)
    return (int(m.group(1)), m.group(2)) if m else None


def remote_generations(store: ObjectStore,
                       step: Optional[int] = None
                       ) -> List[Tuple[int, str]]:
    """COMMITTED remote generations, sorted by (step, generation).
    Generations without a ``COMMIT`` object (uploader died mid-flight)
    are invisible here — the remote analogue of
    :func:`layout.committed_steps`."""
    out = []
    for key in store.list(""):
        if not key.endswith("/" + REMOTE_COMMIT):
            continue
        parsed = parse_remote_prefix(key.rsplit("/", 1)[0])
        if parsed is None:
            continue
        if step is None or parsed[0] == step:
            out.append(parsed)
    return sorted(out)


def remote_steps(store: ObjectStore) -> List[int]:
    """Sorted steps with at least one committed remote generation."""
    return sorted({s for s, _ in remote_generations(store)})


def read_remote_commit(store: ObjectStore, step: int,
                       generation: str) -> dict:
    """Parsed remote COMMIT object of one committed generation."""
    raw = store.get(f"{remote_prefix(step, generation)}/{REMOTE_COMMIT}")
    return json.loads(raw.decode())


# ============================================================== manager
@dataclass
class UploadStats:
    """Outcome of one generation's upload (``SaveHandle.wait_uploaded``
    and ``UploadTicket.wait`` return this)."""
    step: int
    generation: str = ""
    n_objects: int = 0          # payload objects this generation owns
    n_uploaded: int = 0         # actually transferred this attempt
    n_skipped: int = 0          # already present (idempotent retry OR
    #                             content-addressed dedup hit)
    n_deduped: int = 0          # the dedup share of n_skipped: payload
    #                             bytes another step/generation already
    #                             put under the same cas/ digest
    bytes_uploaded: int = 0
    bytes_deduped: int = 0      # payload bytes dedup made metadata-only
    retries: int = 0            # per-object retry attempts consumed
    attempts: int = 0           # total put attempts (incl. first tries)
    backoff_seconds: float = 0.0    # time slept between retry attempts
    seconds: float = 0.0
    committed: bool = False     # remote COMMIT written (observable)


class UploadTicket:
    """Future for one enqueued generation upload; completed by the
    manager's worker thread. ``wait`` re-raises the upload's failure."""

    def __init__(self, step: int):
        self.step = step
        self._done = threading.Event()
        self._stats: Optional[UploadStats] = None
        self._exc: Optional[BaseException] = None

    def _finish(self, stats: Optional[UploadStats] = None,
                exc: Optional[BaseException] = None):
        self._stats, self._exc = stats, exc
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> UploadStats:
        if not self._done.wait(timeout):
            raise TimeoutError(f"upload of step {self.step} still in "
                               f"flight")
        if self._exc is not None:
            raise self._exc
        return self._stats

    result = wait

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        if not self._done.wait(timeout):
            raise TimeoutError(f"upload of step {self.step} still in "
                               f"flight")
        return self._exc

    def __repr__(self):
        st = "done" if self.done() else "pending"
        return f"UploadTicket(step={self.step}, {st})"


class UploadManager:
    """Background worker streaming sealed generations to an object
    store, strictly AFTER the local commit — the hot path never blocks
    on the remote tier.

    Queue lifecycle: ``enqueue`` is called with an already-committed
    step directory and its marker; the single worker thread uploads
    payload objects (skipping keys that already exist with the right
    size — idempotent retry), then writes the remote ``COMMIT`` object
    last. A step counts as "unuploaded" (pinned against local GC, see
    :meth:`unuploaded_steps`) from enqueue until its remote COMMIT has
    landed; failed uploads stay pinned so retention can never delete
    the only copy of a step whose remote upload did not complete.
    """

    def __init__(self, store: Union[str, ObjectStore],
                 volume_roots: Optional[Sequence[str]] = None,
                 max_retries: int = 2, retry_backoff: float = 0.05,
                 retry_policy: Optional[retry.RetryPolicy] = None):
        self.store = make_store(store)
        self.volume_roots = (list(volume_roots) if volume_roots else None)
        self.max_retries = max_retries
        self.retry_backoff = retry_backoff
        # shared retry discipline (repro_torch.core.retry): exponential
        # backoff + full jitter, replacing the old bounded
        # immediate-retry loop; an explicit policy wins over the
        # legacy (max_retries, retry_backoff) knobs
        self.retry_policy = retry_policy or retry.RetryPolicy(
            max_retries=max_retries, base_backoff=retry_backoff)
        self._q: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._pending: Dict[int, int] = {}   # step → enqueued-not-committed
        self._failed: Dict[int, int] = {}    # step → failed attempts
        self._tickets: List[UploadTicket] = []
        self.total = UploadStats(step=-1)    # aggregate across uploads
        self._t: Optional[threading.Thread] = None

    # ------------------------------------------------------------ submit
    def enqueue(self, step: int, directory: str,
                marker: Optional[dict] = None) -> UploadTicket:
        """Queue one committed checkpoint for upload.

        Args:
            step: the checkpoint step.
            directory: its PUBLISHED primary directory.
            marker: the parsed local COMMIT marker; read from
                ``directory`` when omitted.

        Returns:
            an :class:`UploadTicket`; ``wait()`` yields the
            :class:`UploadStats` once the remote COMMIT has landed.
        """
        if marker is None:
            marker = layout.verify_commit(directory, deep=False)
        ticket = UploadTicket(step)
        with self._lock:
            self._pending[step] = self._pending.get(step, 0) + 1
            self._tickets.append(ticket)
            self._start_locked()
        self._q.put(("upload", step, directory, marker, ticket))
        return ticket

    def enqueue_prune(self, keep_last: int, on_done=None) -> UploadTicket:
        """Queue a remote-retention sweep (:meth:`prune_remote`) on the
        worker thread — the training thread must never block on
        full-bucket lists/deletes over the WAN. ``on_done`` (if given)
        is called from the worker with the pruned step list. The
        returned ticket's ``wait()`` yields that list."""
        ticket = UploadTicket(step=-1)
        with self._lock:
            self._tickets.append(ticket)
            self._start_locked()
        self._q.put(("prune", keep_last, on_done, ticket))
        return ticket

    def _start_locked(self):
        if self._t is None:
            self._t = threading.Thread(target=self._run, daemon=True,
                                       name="ckpt-upload-worker")
            self._t.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if item[0] == "prune":
                _, keep_last, on_done, ticket = item
                try:
                    victims = self.prune_remote(keep_last)
                    if on_done is not None:
                        on_done(victims)
                except BaseException as e:
                    ticket._finish(exc=e)
                else:
                    ticket._finish(stats=victims)
                continue
            _, step, directory, marker, ticket = item
            try:
                stats = self._upload_one(step, directory, marker)
            except BaseException as e:
                with self._lock:
                    self._consume_pending(step)
                    # the step stays pinned through _failed until some
                    # retry commits remotely — local GC must keep what
                    # may be the only durable copy
                    self._failed[step] = self._failed.get(step, 0) + 1
                ticket._finish(exc=e)
            else:
                with self._lock:
                    self._consume_pending(step)
                    self._failed.pop(step, None)
                ticket._finish(stats=stats)

    def _consume_pending(self, step: int):
        # caller holds self._lock
        n = self._pending.get(step, 1) - 1
        if n <= 0:
            self._pending.pop(step, None)
        else:
            self._pending[step] = n

    # ------------------------------------------------------------ upload
    def _put_with_retry(self, key: str, path: str,
                        stats: UploadStats) -> None:
        rst = retry.RetryStats()
        try:
            retry.call_with_retry(lambda: self.store.put_file(key, path),
                                  self.retry_policy, stats=rst)
        finally:
            # surface the attempt/backoff accounting even when the
            # budget is exhausted — a failed upload's cost is the most
            # interesting one
            stats.retries += rst.retries
            stats.attempts += rst.attempts
            stats.backoff_seconds += rst.backoff_seconds

    def _upload_one(self, step: int, directory: str,
                    marker: dict) -> UploadStats:
        t0 = time.perf_counter()
        gen = remote_generation(marker)
        prefix = remote_prefix(step, gen)
        files = layout.commit_files(directory, marker, self.volume_roots,
                                    digests=True)
        stats = UploadStats(step=step, generation=gen,
                            n_objects=len(files))
        commit_key = f"{prefix}/{REMOTE_COMMIT}"
        if self.store.exists(commit_key):
            # a previous attempt (or another uploader) already committed
            # this exact generation — re-uploading would be pure waste
            stats.n_skipped = len(files)
            stats.committed = True
            stats.seconds = time.perf_counter() - t0
            self._fold(stats)
            return stats
        # content-addressed payloads (DESIGN.md §12): every object is
        # keyed by its digest, so a shard whose bytes any OTHER step/
        # generation already uploaded is a metadata-only skip here —
        # and a retry of THIS generation skips its own landed objects
        # exactly as before (same digest → same key)
        for f in files:
            key = cas_key(entry_digest(f))
            if self.store.size(key) == f["size"]:
                stats.n_skipped += 1
                stats.n_deduped += 1
                stats.bytes_deduped += f["size"]
                continue
            self._put_with_retry(key, f["path"], stats)
            stats.n_uploaded += 1
            stats.bytes_uploaded += f["size"]
        # the remote commit point: observable only once every payload
        # object above is durably in place. Carries the full per-shard
        # (volume, size, crc32) manifest so hydration can verify every
        # byte without the local copy.
        remote_marker = dict(marker)
        # the local marker's "generation" key is the SAVE nonce that
        # delta chains match on — keep it intact and record the
        # content-derived remote nonce under its own key
        remote_marker["remote_generation"] = gen
        remote_marker["objects"] = {f["name"]: f["size"] for f in files}
        remote_marker["object_crc32"] = {
            f["name"]: f["crc32"] for f in files if "crc32" in f}
        remote_marker["object_digest"] = {
            f["name"]: entry_digest(f) for f in files}
        # recency record: the content-derived nonce is deliberately NOT
        # ordered, so when a re-saved step leaves several committed
        # generations, hydration picks the one committed last by this
        # stamp (never rewritten on an idempotent re-run — the COMMIT
        # short-circuit above keeps the first commit time)
        remote_marker["uploaded_at"] = time.time()
        self.store.put(commit_key,
                       json.dumps(remote_marker, sort_keys=True).encode())
        stats.committed = True
        stats.seconds = time.perf_counter() - t0
        self._fold(stats)
        return stats

    def _fold(self, s: UploadStats):
        with self._lock:
            t = self.total
            t.n_objects += s.n_objects
            t.n_uploaded += s.n_uploaded
            t.n_skipped += s.n_skipped
            t.n_deduped += s.n_deduped
            t.bytes_uploaded += s.bytes_uploaded
            t.bytes_deduped += s.bytes_deduped
            t.retries += s.retries
            t.attempts += s.attempts
            t.backoff_seconds += s.backoff_seconds
            t.seconds += s.seconds
            t.step = max(t.step, s.step)

    # ------------------------------------------------------------- query
    def unuploaded_steps(self) -> List[int]:
        """Steps enqueued (or failed) whose remote COMMIT has not
        landed — the retention pin set: local GC must not delete these,
        they may be the only durable copy."""
        with self._lock:
            return sorted({*self._pending, *self._failed})

    def pending(self) -> int:
        with self._lock:
            return sum(self._pending.values())

    # ------------------------------------------------------------- drain
    def drain(self) -> List[UploadStats]:
        """Block until every enqueued job finished; re-raises the
        FIRST failure (after waiting for all). Returns the per-ticket
        results of the successful ones (:class:`UploadStats` for
        uploads, pruned step lists for queued prunes)."""
        with self._lock:
            tickets, self._tickets = self._tickets, []
        out, err = [], None
        for t in tickets:
            t._done.wait()
            if t._exc is not None:
                err = err or t._exc
            else:
                out.append(t._stats)
        if err is not None:
            raise err
        return out

    def close(self, drain: bool = True):
        """Stop the worker thread; ``drain`` first by default so no
        queued generation is silently dropped."""
        if drain:
            try:
                self.drain()
            finally:
                self._stop()
        else:
            self._stop()

    def _stop(self):
        with self._lock:
            t, self._t = self._t, None
        if t is not None:
            self._q.put(None)
            t.join()

    # --------------------------------------------------------- remote GC
    def prune_remote(self, keep_last: int) -> List[int]:
        """Remote retention: delete all generations of every remote
        step beyond the ``keep_last`` most recent. Steps still pinned
        (enqueued/failed locally) are never pruned. The COMMIT object
        is deleted FIRST — that atomically un-commits the remote
        generation, so a crash mid-prune leaves only unreferenced
        payload objects, mirroring :func:`layout.delete_step`.

        Delta chains pin transitively on the remote tier too: a kept
        step whose remote COMMIT records a delta keeps its base step
        (and so on down to the keyframe), else the surviving delta
        generation could never be hydrated."""
        return prune_store(self.store, keep_last,
                           pinned=self.unuploaded_steps())


def prune_store(store: ObjectStore, keep_last: int,
                pinned: Iterable[int] = ()) -> List[int]:
    """COMMIT-first retention sweep of ONE object store holding
    ``ckpt_<step>.gen-<nonce>/`` generations — shared by the remote
    tier (:meth:`UploadManager.prune_remote`) and the peer tier
    (:meth:`repro_torch.core.peer.PeerReplicator.prune_peers`).

    Keeps the ``keep_last`` most recent steps plus every ``pinned``
    step, then expands the keep set with every delta-chain ancestor a
    kept generation references (a surviving delta must always stay
    hydratable). Victims are deleted newest-first, and each
    generation's COMMIT object is deleted FIRST — that atomically
    un-commits it, so a crash mid-prune leaves only unreferenced
    payload objects (the store analogue of
    :func:`repro_torch.core.layout.delete_step`). ``keep_last <= 0`` keeps
    everything. Returns the pruned steps, sorted."""
    if keep_last <= 0:
        return []
    steps = remote_steps(store)
    keep = set(steps[-keep_last:]) | set(pinned)
    frontier, seen = list(keep), set()
    while frontier:
        s = frontier.pop()
        if s in seen:
            continue
        seen.add(s)
        for st, gen in remote_generations(store, s):
            d = read_remote_commit(store, st, gen).get("delta")
            if isinstance(d, dict) and "base_step" in d:
                b = int(d["base_step"])
                if b not in keep:
                    keep.add(b)
                    frontier.append(b)
    victims = [s for s in steps if s not in keep]
    # newest-first, so a crash mid-prune never strands a delta
    # whose (older) base is already gone
    for s in sorted(victims, reverse=True):
        for st, gen in remote_generations(store, s):
            prefix = remote_prefix(st, gen)
            store.delete(f"{prefix}/{REMOTE_COMMIT}")
            for key in store.list(prefix + "/"):
                store.delete(key)
    if victims:
        # refcount sweep of the content-addressed keyspace: with the
        # victims' COMMITs gone, any cas/ digest no surviving COMMIT
        # references is garbage — and one still referenced (a shard
        # shared across steps) MUST survive, which is exactly what the
        # reference walk guarantees (deleting per-prefix would not)
        collect_cas_orphans(store)
    return sorted(victims)


# ============================================================ hydration
@dataclass
class HydrateStats:
    """Byte-level accounting of one :func:`hydrate` call (covering the
    WHOLE delta chain when the target step is a delta). ``reused_bytes``
    never crossed the wire (verified local copies); ``fetched_bytes``
    did; ``cache_hit_bytes`` came out of the serving read cache — the
    dedup/cache win is exactly the bytes NOT in ``fetched_bytes``."""
    steps: List[int] = field(default_factory=list)   # hydrated, chain order
    n_objects: int = 0
    n_reused: int = 0
    n_fetched: int = 0
    reused_bytes: int = 0
    fetched_bytes: int = 0          # bytes actually pulled from the store
    cache_hit_bytes: int = 0        # bytes served from the read cache
    seconds: float = 0.0


def hydrate(store: Union[str, ObjectStore], primary_root: str,
            step: Optional[int] = None, generation: Optional[str] = None,
            io_config=None, verify: bool = True, readers: int = 1,
            cache=None, stats: Optional[HydrateStats] = None) -> int:
    """Rebuild a local checkpoint from a committed REMOTE generation —
    the restore half of the tiered design (``engine.load(tier="remote")``
    lands here).

    The rebuild goes through the SAME local commit protocol as a save:
    objects land in a ``ckpt_<step>.tmp`` staging dir, a fresh local
    COMMIT seals it, and :func:`layout.publish` atomically replaces any
    existing (possibly corrupted) local copy — a crash mid-hydration
    leaves only ``.tmp`` debris. Every shard with a recorded CRC32 is
    verified against the remote manifest via the async span reader
    (:func:`repro_torch.core.reader.read_stream` — same integrity machinery
    as the parallel restore path); local shard files that already
    verify are reused instead of re-downloaded, so hydration only moves
    the bytes that are actually missing or corrupted.

    All hydrated shards become primary-resident (the remote tier has no
    volume topology), so the local marker is stamped with volume 0 for
    every shard and no ``volume_dirs`` — readable by any layout
    version's reader.

    Args:
        store: object store (spec string or instance).
        primary_root: the engine's primary checkpoint directory.
        step: remote step to hydrate; latest committed when None.
        generation: specific remote generation; when None and several
            committed generations of ``step`` exist, the
            lexicographically last wins (any committed one is valid).
        io_config: a :class:`repro_torch.core.writer.WriterConfig` for the
            CRC read-back (backend/queue-depth knobs); defaults used
            when None.
        verify: CRC-check downloaded AND reused shards (on by default;
            size checks always happen).
        readers: concurrent range-fetch workers (DESIGN.md §12) — the
            generation's missing bytes are striped across ``readers``
            ranged downloads, the read-side mirror of fig10's parallel
            restore. ``1`` reproduces the serial object-by-object path;
            stores without ranged ``get_to`` fall back to whole-object
            fetches pooled ``readers`` wide.
        cache: optional :class:`repro_torch.core.serve.ReadCache`; digest-
            keyed objects are read THROUGH it, so repeated hydrations
            (and per-tensor serving reads) share one local copy.
        stats: optional :class:`HydrateStats` accumulator, filled in
            place across the whole delta chain.

    Returns:
        the hydrated step.

    Delta chains (DESIGN.md §9): when the hydrated step's remote COMMIT
    records a delta, its base generation is hydrated too — selected by
    the SAVE nonce the delta pinned (``base_gen``), never by recency —
    and so on down to the keyframe, so the local directory afterwards
    holds the complete replayable chain.

    Raises:
        FileNotFoundError: no committed remote generation matches (or
            a delta chain's base generation is gone from the store).
        IOError: a downloaded object fails its size or CRC check.
    """
    store = make_store(store)
    t0 = time.perf_counter()
    try:
        first, commit = _hydrate_one(store, primary_root, step, generation,
                                     io_config, verify, readers=readers,
                                     cache=cache, stats=stats)
        hops = 0
        while True:
            dinfo = commit.get("delta")
            if not isinstance(dinfo, dict) or "base_step" not in dinfo:
                return first
            hops += 1
            if hops > 10000:
                raise IOError(
                    f"remote delta chain rooted at step {first} exceeds "
                    f"10000 links — cyclic or corrupt COMMIT metadata")
            _, commit = _hydrate_one(
                store, primary_root, int(dinfo["base_step"]), None,
                io_config, verify,
                save_generation=dinfo.get("base_gen", ""),
                readers=readers, cache=cache, stats=stats)
    finally:
        if stats is not None:
            stats.seconds += time.perf_counter() - t0


def select_remote_generation(store: ObjectStore,
                             step: Optional[int] = None,
                             generation: Optional[str] = None,
                             save_generation: Optional[str] = None
                             ) -> Tuple[int, str, dict]:
    """Pick ONE committed remote generation — ``(step, generation,
    parsed COMMIT)`` — by the same rules hydration uses, shared with
    the per-tensor serving path (:mod:`repro_torch.core.serve`): an explicit
    ``generation`` wins; a ``save_generation`` matches the local SAVE
    nonce a delta pinned; otherwise the newest ``uploaded_at`` of the
    latest step (a re-saved step can leave several committed
    generations and the content-derived nonces carry no order).

    Raises:
        FileNotFoundError: nothing committed matches."""
    gens = remote_generations(store, step)
    if not gens:
        raise FileNotFoundError(
            f"no committed remote checkpoint generation"
            f"{f' for step {step}' if step is not None else ''} in the "
            f"object store")
    if generation is not None:
        matches = [(s, g) for s, g in gens if g == generation]
        if not matches:
            raise FileNotFoundError(
                f"remote generation {generation!r} not found")
        step, generation = matches[-1]
        return step, generation, read_remote_commit(store, step, generation)
    if save_generation is not None:
        found = None
        for s, g in gens:
            c = read_remote_commit(store, s, g)
            if c.get("generation", "") == save_generation:
                found = (s, g, c)
        if found is None:
            raise FileNotFoundError(
                f"no committed remote generation of step {step} carries "
                f"save generation {save_generation!r} — the delta "
                f"chain's base is gone from the object store")
        return found
    step = gens[-1][0]
    best = None
    for s, g in gens:
        if s != step:
            continue
        c = read_remote_commit(store, s, g)
        key = (c.get("uploaded_at", 0.0), g)
        if best is None or key > best[0]:
            best = (key, g, c)
    return step, best[1], best[2]


def _hydrate_one(store: ObjectStore, primary_root: str,
                 step: Optional[int], generation: Optional[str],
                 io_config, verify: bool,
                 save_generation: Optional[str] = None,
                 readers: int = 1, cache=None,
                 stats: Optional[HydrateStats] = None
                 ) -> Tuple[int, dict]:
    """Hydrate exactly ONE remote generation (no chain walking);
    returns ``(step, remote commit dict)``. ``save_generation`` selects
    by the local SAVE nonce recorded in the remote COMMIT — how a delta
    pins its exact base image across re-saves of the same step."""
    step, generation, commit = select_remote_generation(
        store, step, generation, save_generation)
    prefix = remote_prefix(step, generation)

    os.makedirs(primary_root, exist_ok=True)
    staging = os.path.join(primary_root, layout.staging_dir_name(step))
    final = os.path.join(primary_root, layout.step_dir_name(step))
    if os.path.exists(staging):
        shutil.rmtree(staging)
    os.makedirs(staging)

    crc_by_name = commit.get("object_crc32") or {}
    digest_by_name = commit.get("object_digest") or {}
    objects: Dict[str, int] = commit.get("objects") or {}
    # where a pre-existing local copy of each object might live
    local_candidates = _local_candidates(primary_root, final, commit)
    if stats is not None:
        stats.steps.append(step)
        stats.n_objects += len(objects)
    try:
        jobs: List[dict] = []
        for name, size in sorted(objects.items()):
            want_crc = crc_by_name.get(name)
            dst = os.path.join(staging, name)
            src = local_candidates.get(name)
            if src is not None and _file_ok(src, size, want_crc,
                                            io_config, verify):
                shutil.copyfile(src, dst)     # local bytes still good
                if stats is not None:
                    stats.n_reused += 1
                    stats.reused_bytes += size
                continue
            jobs.append({"key": object_key(commit, prefix, name),
                         "name": name, "size": size, "crc": want_crc,
                         "digest": digest_by_name.get(name), "dst": dst})
        verified = _fetch_objects(store, jobs, io_config, verify,
                                  readers, cache, stats)
        for j in jobs:
            actual = os.path.getsize(j["dst"])
            if actual != j["size"]:
                raise IOError(
                    f"remote object {j['name']} is {actual} bytes, "
                    f"remote COMMIT recorded {j['size']} — torn upload")
            if (verify and j["crc"] is not None
                    and j["name"] not in verified):
                got = _file_crc32(j["dst"], j["size"], io_config)
                if got != j["crc"]:
                    raise IOError(
                        f"checkpoint corruption: remote shard "
                        f"{j['name']} crc {got:#x} != remote COMMIT "
                        f"{j['crc']:#x} (hydration path)")
        if verify and "manifest_crc32" in commit:
            crc = layout.manifest_crc32(staging)
            if crc != commit["manifest_crc32"]:
                raise IOError(
                    f"hydrated manifest crc {crc:#x} != remote COMMIT "
                    f"{commit['manifest_crc32']:#x}")
        shards = [{"name": sh["name"], "volume": 0, "size": sh["size"],
                   **({"crc32": sh["crc32"]} if "crc32" in sh else {})}
                  for sh in commit.get("shards", [])]
        layout.write_commit_marker(
            staging, step, commit.get("backend", "fastpersist"),
            shards=shards or None,
            generation=commit.get("generation") or None,
            delta=commit.get("delta") or None)
        layout.publish(staging, final)
    except BaseException:
        shutil.rmtree(staging, ignore_errors=True)
        raise
    return step, commit


def _fetch_objects(store: ObjectStore, jobs: List[dict], io_config,
                   verify: bool, readers: int, cache,
                   stats: Optional[HydrateStats]) -> set:
    """Download the missing objects of one generation, ``readers`` wide
    (DESIGN.md §12). Each job is ``{key, name, size, crc, digest,
    dst}``; bytes land at ``dst``. Returns the job NAMES whose bytes
    were already CRC-verified in flight (cache fills verify on fill),
    so the caller skips a redundant second sweep.

    Three paths, best applicable wins per job:

      * **read cache** — digest-keyed jobs assemble through the
        :class:`repro_torch.core.serve.ReadCache` (block-parallel, verified
        on fill, shared across hydrations and per-tensor reads);
      * **striped ranges** — with a ranged-capable store and
        ``readers > 1``, the jobs' concatenated bytes are striped into
        ``readers`` balanced ranges (:func:`partition.stripe_ranges` —
        the same carve the local parallel-restore planner uses), each
        worker range-fetching its slices to scratch files and splicing
        them into the destinations;
      * **legacy** — stores without ranged ``get_to`` (or a single
        reader) fetch whole objects, pooled ``readers`` wide across
        objects. A 1-object hydration on a legacy store is exactly one
        download, as before the serving layer existed.
    """
    verified: set = set()
    if not jobs:
        return verified
    readers = max(1, int(readers))
    lock = threading.Lock()

    def _count(fetched: int, hit: int = 0):
        if stats is None:
            return
        with lock:
            stats.fetched_bytes += fetched
            stats.cache_hit_bytes += hit

    cached_jobs: List[dict] = []
    direct_jobs: List[dict] = []
    for j in jobs:
        (cached_jobs if cache is not None and j["digest"]
         else direct_jobs).append(j)

    from concurrent.futures import ThreadPoolExecutor

    for j in cached_jobs:
        hit, fetched = cache.fetch_file(
            store, j["key"], j["digest"], j["size"], j["dst"],
            crc=j["crc"] if verify else None, readers=readers,
            io_config=io_config)
        _count(fetched, hit)
        if verify and j["crc"] is not None:
            verified.add(j["name"])      # cache verified the assembly

    if not direct_jobs:
        if stats is not None:
            with lock:
                stats.n_fetched += len(jobs)
        return verified

    if readers > 1 and supports_ranged_get(store):
        # stripe the concatenation of all missing bytes into balanced
        # per-worker ranges; a worker's range may span object borders
        placed, base = [], 0
        for j in direct_jobs:
            placed.append((j, base))
            base += j["size"]
        for j in direct_jobs:             # preallocate splice targets
            with open(j["dst"], "wb") as f:
                f.truncate(j["size"])

        def fetch_range(rng):
            lo, hi = rng
            moved = 0
            for j, jbase in placed:
                jend = jbase + j["size"]
                if jend <= lo or jbase >= hi:
                    continue
                olo, ohi = max(lo, jbase) - jbase, min(hi, jend) - jbase
                tmp = j["dst"] + f".range-{lo:x}"
                try:
                    store.get_to(j["key"], tmp, offset=olo,
                                 length=ohi - olo)
                    with open(tmp, "rb") as src, \
                            open(j["dst"], "r+b") as out:
                        out.seek(olo)
                        shutil.copyfileobj(src, out, 1 << 20)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
                moved += ohi - olo
            return moved

        from repro_torch.core.partition import stripe_ranges
        with ThreadPoolExecutor(max_workers=readers) as pool:
            for moved in pool.map(fetch_range, stripe_ranges(base, readers)):
                _count(moved)
    else:
        def fetch_whole(j):
            ranged_get_to(store, j["key"], j["dst"])
            return j["size"]

        if readers > 1:
            with ThreadPoolExecutor(max_workers=readers) as pool:
                for moved in pool.map(fetch_whole, direct_jobs):
                    _count(moved)
        else:
            for j in direct_jobs:
                _count(fetch_whole(j))

    if stats is not None:
        with lock:
            stats.n_fetched += len(jobs)
    return verified


def _local_candidates(primary_root: str, final: str,
                      commit: dict) -> Dict[str, str]:
    """{object name: local path} of possibly-reusable local files for a
    step being hydrated — primary-dir payloads plus shards the LOCAL
    marker (if any) striped onto other volumes."""
    out: Dict[str, str] = {}
    if not os.path.isdir(final):
        return out
    local_marker = layout.read_commit_marker(final)
    for name in (commit.get("objects") or {}):
        p = os.path.join(final, name)
        if os.path.isfile(p):
            out[name] = p
    if local_marker is not None:
        for sh in local_marker.get("shards", []):
            d = layout.resolve_shard_dir(local_marker, final,
                                         int(sh.get("volume", 0)))
            p = os.path.join(d, sh["name"])
            if sh["name"] not in out and os.path.isfile(p):
                out[sh["name"]] = p
    return out


def _file_crc32(path: str, size: int, io_config=None) -> int:
    """Thin alias of :func:`repro_torch.core.reader.file_crc32` — kept as a
    module-level seam because tests (and the size-first reuse check)
    count calls through THIS name."""
    from repro_torch.core.reader import file_crc32
    return file_crc32(path, size, io_config)


def _file_ok(path: str, size: int, crc: Optional[int],
             io_config, verify: bool) -> bool:
    """True when a local candidate file matches the remote manifest
    (size always; CRC when recorded and ``verify``)."""
    try:
        if os.path.getsize(path) != size:
            return False
        if verify and crc is not None:
            return _file_crc32(path, size, io_config) == crc
        return True
    except OSError:
        return False
