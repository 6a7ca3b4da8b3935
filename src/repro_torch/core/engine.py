"""Unified checkpoint engine (DESIGN.md §1): ONE public API for every
checkpointing mode of the port.

    spec   = CheckpointSpec(directory="/ckpts", backend="fastpersist-pipelined")
    engine = CheckpointEngine(spec)
    handle = engine.save(state, step, extras={"step": step})   # SaveHandle
    ...
    engine.wait()                  # §4.3 sync point (no-op for sync backends)
    stats  = handle.result()       # unified SaveStats
    state, manifest = engine.load(like=state, device="cuda")

A copy of ``repro.core.engine``: the same backends under the same
registry keys (the COMMIT marker records the key, so either package
reads the other's checkpoints), the same crash-atomic commit protocol
(``ckpt_<step>.tmp/`` + manifest-checksummed ``COMMIT`` + atomic rename,
:mod:`repro_torch.core.layout`), the same snapshot-granular sync point,
and the same durability tiers: the ``fastpersist-tiered[-pipelined]``
backends upload each committed generation to an object store
(DESIGN.md §8), the peer tier replicates it (§11), and
``load(tier="remote"|"peer")`` / ``load_tensor(tier=...)`` restore or
serve from them (§12). Restored tensors are placed with
``.to(device)``.
"""
from __future__ import annotations

import inspect
import os
import queue
import shutil
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import layout
from repro_torch.core.baseline import BaselineCheckpointer
from repro_torch.core.checkpointer import (FastPersistCheckpointer,
                                           FastPersistConfig, SaveStats)
from repro_torch.core.partition import probe_volumes
from repro_torch.tree import flatten, unflatten


# ===================================================================== spec
@dataclass
class CheckpointSpec:
    """Everything the engine needs; the single configuration surface."""
    directory: str
    backend: str = "fastpersist"
    fp: FastPersistConfig = field(default_factory=FastPersistConfig)
    baseline_buffer_size: int = 64 * 1024
    max_outstanding: int = 1        # async backends: in-flight save bound
    fsync_commit: bool = True       # fsync COMMIT + parent dir on publish
    verify_on_load: bool = True
    clean_stale_staging: bool = True    # sweep crashed writers' .tmp dirs
    #: destination volume roots for sharded payloads (the paper's
    #: per-node SSDs; here: directory roots, e.g. one per mounted disk).
    #: None/empty → shards live in ``directory`` (single-volume layout).
    #: The manifest + global COMMIT always live under ``directory``.
    volumes: Optional[Sequence[str]] = None
    #: second durability tier (DESIGN.md §8): object-store spec for the
    #: ``fastpersist-tiered`` backends — a path / ``file://`` URL (the
    #: mock bucket), a registered ``scheme://`` URL, or an
    #: :class:`repro_torch.core.upload.ObjectStore` instance. Also enables
    #: ``engine.load(tier="remote")`` hydration for any backend.
    upload_store: Optional[object] = None
    #: per-object upload retry budget for the tiered backends
    upload_max_retries: int = 2
    #: peer-replication tier (DESIGN.md §11): replication targets for
    #: ANY backend — ``[name=]store[@failure_domain]`` specs,
    #: :class:`repro_torch.core.peer.PeerConfig` instances, or store objects.
    #: After each local COMMIT the sealed generation (full delta chain)
    #: is streamed to peers in the background; ``SaveHandle.
    #: wait_replicated()`` is the peer-tier durability point and
    #: ``engine.load(tier="peer")`` restores from the healthiest peer.
    peers: Optional[Sequence[object]] = None
    #: replicas each checkpoint should reach (placed across distinct
    #: failure domains when available)
    replication_factor: int = 2
    #: this WRITER's failure domain — placement avoids it whenever any
    #: other usable domain exists
    failure_domain: Optional[str] = None
    #: per-attempt wall-clock deadline on every peer operation (seconds;
    #: None = unbounded) — a hung peer must never wedge the replicator
    peer_op_timeout: Optional[float] = 30.0
    #: concurrent range-fetch workers for remote/peer hydration
    #: (DESIGN.md §12) — the read-side mirror of the parallel restore
    #: width; 1 = serial object-by-object download
    hydrate_readers: int = 4
    #: hot-shard read cache budget in MiB (DESIGN.md §12): 0 disables;
    #: > 0 backs hydration and ``load_tensor(tier="remote"|"peer")``
    #: with a digest-keyed LRU block cache at
    #: ``<directory>/.serve-cache``
    serve_cache_mb: int = 0


# ================================================================== handle
class SaveHandle:
    """Future for one checkpoint save. Sync backends hand back handles
    that are already done; async backends complete them from the helper
    thread. ``wait``/``result`` re-raise the save's exception.

    Tiered backends (DESIGN.md §8) additionally carry the save's upload
    future: ``wait()`` is the LOCAL durability point (crash-atomic
    commit on NVMe), :meth:`wait_uploaded` the REMOTE one (COMMIT
    object in the store). For backends without an upload tier,
    ``wait_uploaded`` degrades to ``wait`` and returns None.
    """

    def __init__(self, step: int, backend: str):
        self.step = step
        self.backend = backend
        self._done = threading.Event()
        self._snapshotted = threading.Event()
        self._stats: Optional[SaveStats] = None
        self._exc: Optional[BaseException] = None
        self._upload = None          # UploadTicket, attached pre-finish
        self._replication = None     # ReplicationTicket, ditto (§11)

    @classmethod
    def completed(cls, step: int, backend: str,
                  stats: SaveStats) -> "SaveHandle":
        h = cls(step, backend)
        h._finish(stats=stats)
        return h

    def _finish(self, stats: Optional[SaveStats] = None,
                exc: Optional[BaseException] = None):
        self._stats, self._exc = stats, exc
        # a finished save's snapshot is trivially over (success OR
        # failure, and backends without snapshot signalling) — nobody
        # may hang in wait_snapshot
        self._snapshotted.set()
        self._done.set()

    def _mark_snapshot(self):
        # backend callback (bind_snapshot): the device→staging copy has
        # fully landed; the write may still be in flight
        self._snapshotted.set()

    def done(self) -> bool:
        return self._done.is_set()

    def snapshot_done(self) -> bool:
        """True once the save's device→host snapshot has landed (the
        write may still be in flight). Backends without snapshot
        signalling flip this together with :meth:`done`."""
        return self._snapshotted.is_set()

    def wait_snapshot(self, timeout: Optional[float] = None):
        """Block until the snapshot (device→staging copy) of this save
        has landed — the earliest point a training step that updates the
        state in place may safely run (DESIGN.md §10). The write keeps
        overlapping that step; ``wait()`` remains the local durability
        point.

        Raises:
            TimeoutError: snapshot still in flight after ``timeout``.
            BaseException: the save's failure, when it already failed.
        """
        if not self._snapshotted.wait(timeout):
            raise TimeoutError(
                f"snapshot of step {self.step} still in flight")
        if self._done.is_set() and self._exc is not None:
            raise self._exc

    def wait(self, timeout: Optional[float] = None) -> SaveStats:
        """Block until the LOCAL commit completed.

        Args:
            timeout: seconds to wait (None = forever).

        Returns:
            the save's unified :class:`SaveStats`.

        Raises:
            TimeoutError: still in flight after ``timeout``.
            BaseException: the save's own failure, re-raised.
        """
        if not self._done.wait(timeout):
            raise TimeoutError(f"save of step {self.step} still in flight")
        if self._exc is not None:
            raise self._exc
        return self._stats

    result = wait

    def _attach_upload(self, ticket):
        # called by the engine AFTER the local commit and BEFORE this
        # handle is finished, so wait() → wait_uploaded() never races
        self._upload = ticket

    def uploaded(self) -> bool:
        """True once the remote COMMIT landed (or there is no upload
        tier and the local save is done). A FAILED upload is not
        "uploaded" — its step has no observable remote generation."""
        if not self.done():
            return False
        if self._upload is None:
            return True
        return self._upload.done() and self._upload._exc is None

    def wait_uploaded(self, timeout: Optional[float] = None):
        """Block until this save is durable on the REMOTE tier.

        Args:
            timeout: seconds to wait (None = forever); ONE budget
                covering the local wait and the upload together.

        Returns:
            the save's :class:`repro_torch.core.upload.UploadStats`, or None
            when the backend has no upload tier.

        Raises:
            TimeoutError: local save or upload still in flight.
            BaseException: the save's or the upload's failure.
        """
        t0 = time.perf_counter()
        self.wait(timeout)
        if self._upload is None:
            return None
        remaining = (None if timeout is None else
                     max(timeout - (time.perf_counter() - t0), 0.0))
        return self._upload.wait(remaining)

    def _attach_replication(self, ticket):
        # like _attach_upload: attached AFTER the local commit, BEFORE
        # the handle finishes — wait() → wait_replicated() never races
        self._replication = ticket

    def replicated(self) -> bool:
        """True once the peer tier holds this save (the replication job
        committed its chain to at least one peer), or there is no peer
        tier and the local save is done. A FAILED replication — zero
        peers committed — is never "replicated"."""
        if not self.done():
            return False
        if self._replication is None:
            return True
        if not self._replication.done() or \
                self._replication._exc is not None:
            return False
        stats = self._replication._stats
        return bool(stats is not None and stats.committed)

    def wait_replicated(self, timeout: Optional[float] = None):
        """Block until this save is durable on the PEER tier (DESIGN.md
        §11) — the first OFF-NODE durability point, expected orders of
        magnitude before :meth:`wait_uploaded`'s object-store commit.

        Args:
            timeout: seconds to wait (None = forever); ONE budget
                covering the local wait and ALL K peer transfers
                together — never K stacked timeouts.

        Returns:
            the save's :class:`repro_torch.core.peer.ReplicationStats`
            (``under_replicated`` flags a degraded K' < K landing), or
            None when no peer tier is configured.

        Raises:
            TimeoutError: local save or replication still in flight.
            BaseException: the save's failure, or the replication's —
                a replication that committed to NO peer raises
                :class:`repro_torch.core.peer.ReplicationError` here and
                never reports durable.
        """
        t0 = time.perf_counter()
        self.wait(timeout)
        if self._replication is None:
            return None
        remaining = (None if timeout is None else
                     max(timeout - (time.perf_counter() - t0), 0.0))
        return self._replication.wait(remaining)

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        if not self._done.wait(timeout):
            raise TimeoutError(f"save of step {self.step} still in flight")
        return self._exc

    def __repr__(self):
        st = "done" if self.done() else "pending"
        return f"SaveHandle(step={self.step}, backend={self.backend}, {st})"


# ================================================================ backends
class CheckpointBackend:
    """Payload strategy: HOW bytes reach a directory. The engine owns
    WHERE (staging) and WHEN it becomes visible (commit protocol)."""

    #: async backends persist on a helper thread; the engine returns a
    #: pending SaveHandle and completes it off the critical path.
    async_save = False

    def __init__(self, spec: CheckpointSpec):
        self.spec = spec

    def write_payload(self, state, step: int, extras: Optional[dict],
                      directory: str) -> SaveStats:
        raise NotImplementedError

    def write_payload_sharded(self, state, step: int,
                              extras: Optional[dict], directory: str,
                              volume_dirs: List[str]) -> SaveStats:
        """Multi-volume write hook: ``directory`` is the primary staging
        dir (manifest + COMMIT home), ``volume_dirs[v]`` the staging dir
        for volume ``v`` (may alias ``directory``). Backends that are
        volume-agnostic inherit this default and keep working."""
        return self.write_payload(state, step, extras, directory)

    def read_payload(self, directory: str, step: int, like=None,
                     verify: bool = True) -> Tuple[object, object]:
        raise NotImplementedError

    def read_payload_sharded(self, directory: str, step: int, like=None,
                             verify: bool = True, marker=None,
                             volume_roots=None, parallel=None,
                             device=None) -> Tuple[object, object]:
        """Multi-volume read hook; the default ignores the shard context,
        the parallel-restore request and the target device (single-dir
        backends never need them; the engine places the result)."""
        return self.read_payload(directory, step, like=like, verify=verify)

    def invalidate_arena(self):
        """Drop any cached serialize-arena layout (the trainer calls this
        when the state object was replaced). Default: nothing cached."""

    def bind_snapshot(self, callback):
        """Install the one-shot snapshot-complete callback for the NEXT
        save (DESIGN.md §10): fire it once the device→staging copy has
        fully landed, while the write may still be in flight. Backends
        without a distinct snapshot stage ignore it — the engine then
        treats snapshot-done as save-done."""

    def after_commit(self, step: int, directory: str, marker: dict,
                     stats: SaveStats):
        """Post-publish hook, called by the engine AFTER the local
        crash-atomic rename with the published ``directory`` and its
        COMMIT ``marker``. Tiered backends enqueue the background
        upload here and return the ``UploadTicket`` (attached to the
        SaveHandle); the default returns None — no second tier."""
        return None

    def close(self):
        pass


class FastPersistBackend(CheckpointBackend):
    """Paper §4: parallel aligned NVMe writers, synchronous commit,
    shards striped across the spec's volumes."""

    def __init__(self, spec: CheckpointSpec):
        super().__init__(spec)
        self._inner = FastPersistCheckpointer(spec.directory, spec.fp)

    def write_payload(self, state, step, extras, directory) -> SaveStats:
        return self._inner.save(state, step, extras, directory=directory)

    def write_payload_sharded(self, state, step, extras, directory,
                              volume_dirs) -> SaveStats:
        return self._inner.save(state, step, extras, directory=directory,
                                volume_dirs=volume_dirs)

    def read_payload(self, directory, step, like=None, verify=True):
        return self._inner.load(step, like=like, verify=verify,
                                directory=directory)

    def read_payload_sharded(self, directory, step, like=None, verify=True,
                             marker=None, volume_roots=None,
                             parallel=None, device=None):
        return self._inner.load(step, like=like, verify=verify,
                                directory=directory, marker=marker,
                                volume_roots=volume_roots,
                                read_plan=parallel, device=device)

    def read_owned(self, directory, step, rank, n_readers, ownership=None,
                   verify=True, marker=None, volume_roots=None):
        return self._inner.read_owned(step, rank, n_readers,
                                      ownership=ownership, verify=verify,
                                      directory=directory, marker=marker,
                                      volume_roots=volume_roots)

    def load_tensor(self, directory, step, name, marker=None,
                    volume_roots=None):
        return self._inner.load_tensor(step, name, directory=directory,
                                       marker=marker,
                                       volume_roots=volume_roots)

    def invalidate_arena(self):
        arena = getattr(self._inner, "_arena", None)
        if arena is not None:
            arena.invalidate()

    def bind_snapshot(self, callback):
        # the checkpointer consumes (and clears) this at save start, so
        # a binding never leaks into a later save
        self._inner.on_snapshot = callback

    def after_commit(self, step, directory, marker, stats):
        # delta chain bookkeeping (DESIGN.md §9): a save may only serve
        # as a delta base once its COMMIT actually published — telling
        # the checkpointer here closes the crash window where a delta
        # would reference a base that never became visible
        self._inner.note_committed(step, marker)
        return None


class PipelinedFastPersistBackend(FastPersistBackend):
    """Paper §4.3: same write path, persisted by the engine's helper
    thread so it overlaps the next iteration's forward/backward."""
    async_save = True


class TieredFastPersistBackend(FastPersistBackend):
    """Tiered durability (DESIGN.md §8): the fastpersist local write
    path, plus an :class:`repro_torch.core.upload.UploadManager` background
    worker that streams each committed generation to the spec's
    ``upload_store`` AFTER the local COMMIT rename — local NVMe for
    speed, the object tier for durability, hot path untouched."""

    def __init__(self, spec: CheckpointSpec):
        super().__init__(spec)
        if spec.upload_store is None:
            raise ValueError(
                f"backend {spec.backend!r} needs CheckpointSpec."
                f"upload_store (a path, file:// / registered scheme:// "
                f"URL, or an ObjectStore instance)")
        from repro_torch.core.upload import UploadManager
        roots = [os.path.abspath(v)
                 for v in (spec.volumes or [spec.directory])]
        self.uploader = UploadManager(spec.upload_store,
                                      volume_roots=roots,
                                      max_retries=spec.upload_max_retries)

    def after_commit(self, step, directory, marker, stats):
        super().after_commit(step, directory, marker, stats)
        return self.uploader.enqueue(step, directory, marker)

    def close(self):
        try:
            self.uploader.close(drain=True)
        finally:
            super().close()


class TieredPipelinedFastPersistBackend(TieredFastPersistBackend):
    """Tiered durability on top of the §4.3 pipelined local write: the
    engine's helper thread persists+commits locally off the critical
    path, then hands the sealed generation to the upload worker."""
    async_save = True


class BaselineBackend(CheckpointBackend):
    """torch.save()-style single buffered writer (paper §3.1)."""

    def __init__(self, spec: CheckpointSpec):
        super().__init__(spec)
        self._inner = BaselineCheckpointer(spec.directory,
                                           spec.baseline_buffer_size)

    def write_payload(self, state, step, extras, directory) -> SaveStats:
        t0 = time.perf_counter()
        bs = self._inner.save(state, step, extras, directory=directory)
        # lift into the unified stats shape: one logical writer, and the
        # baseline interleaves serialize+write so it is all "persist" time
        return SaveStats(total_bytes=bs.bytes_written, seconds=bs.seconds,
                         serialize_seconds=max(
                             time.perf_counter() - t0 - bs.seconds, 0.0),
                         per_writer=[], n_writers=1,
                         arena_reused=bs.arena_reused)

    def read_payload(self, directory, step, like=None, verify=True):
        return self._inner.load(step, like=like, directory=directory)

    def invalidate_arena(self):
        arena = getattr(self._inner, "_arena", None)
        if arena is not None:
            arena.invalidate()


_REGISTRY: Dict[str, Callable[[CheckpointSpec], CheckpointBackend]] = {}


def register_backend(name: str,
                     factory: Callable[[CheckpointSpec], CheckpointBackend],
                     overwrite: bool = False):
    """Register a checkpoint backend under a string key. Third-party
    strategies plug in here and immediately work with Trainer,
    RetentionManager, benchmarks, and the CLI.

    Args:
        name: registry key; what ``CheckpointSpec.backend``, the
            launcher's ``--backend``, and COMMIT markers refer to.
        factory: called with the engine's :class:`CheckpointSpec`,
            returns a :class:`CheckpointBackend`.
        overwrite: replace an existing registration instead of raising
            ``ValueError``.
    """
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"backend {name!r} already registered "
                         f"(pass overwrite=True to replace)")
    _REGISTRY[name] = factory


def unregister_backend(name: str):
    _REGISTRY.pop(name, None)


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_backend_factory(name: str
                        ) -> Callable[[CheckpointSpec], CheckpointBackend]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown checkpoint backend {name!r}; "
                       f"available: {', '.join(available_backends())}")


register_backend("baseline", BaselineBackend)
register_backend("fastpersist", FastPersistBackend)
register_backend("fastpersist-pipelined", PipelinedFastPersistBackend)
register_backend("fastpersist-tiered", TieredFastPersistBackend)
register_backend("fastpersist-tiered-pipelined",
                 TieredPipelinedFastPersistBackend)


# ================================================================== worker
class _SaveWorker:
    """Single helper thread executing queued save jobs in order (the
    paper's §4.3 checkpoint worker). Each job completes its handle."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._t = threading.Thread(target=self._run, daemon=True,
                                   name="ckpt-engine-worker")
        self._t.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            job, handle = item
            try:
                handle._finish(stats=job())
            except BaseException as e:
                handle._finish(exc=e)

    def submit(self, job: Callable[[], SaveStats], handle: SaveHandle):
        self._q.put((job, handle))

    def close(self):
        self._q.put(None)
        self._t.join()


# ================================================================== engine
@dataclass
class EngineStats:
    submitted: int = 0
    committed: int = 0
    failed: int = 0
    stall_seconds: float = 0.0        # caller time blocked in wait()/
    #                                   wait_snapshot()
    snapshot_stall_seconds: float = 0.0   # the wait_snapshot() share of
    #                                       stall_seconds (§10 sync point)
    write_seconds: float = 0.0        # sum of per-save persist wall time
    bytes_written: int = 0
    arena_reuses: int = 0             # saves that refilled a cached arena
    #                                   in place (zero-alloc steady state)
    uploads_enqueued: int = 0         # commits handed to the upload tier
    replications_enqueued: int = 0    # commits handed to the peer tier


class CheckpointEngine:
    """Facade over every checkpointing mode. One save path, one load
    path, one on-disk layout — regardless of backend."""

    def __init__(self, spec: CheckpointSpec):
        self.spec = spec
        os.makedirs(spec.directory, exist_ok=True)
        for root in self.volume_roots():
            try:
                os.makedirs(root, exist_ok=True)
            except OSError as e:
                # a dead volume must not kill the engine: the per-save
                # health probe (partition.probe_volumes) will stripe
                # around it and record it as degraded
                import warnings
                warnings.warn(f"checkpoint volume root {root} is "
                              f"unavailable ({e}); saves will stripe "
                              f"around it", stacklevel=2)
        if spec.clean_stale_staging:
            layout.clean_stale_multi(spec.directory, self.volume_roots())
        self._backend = get_backend_factory(spec.backend)(spec)
        self._read_backends: Dict[str, CheckpointBackend] = {
            spec.backend: self._backend}
        self._remote_store = None       # lazy, for non-tiered backends
        self._serve_cache = None        # lazy, DESIGN.md §12 read cache
        #: :class:`repro_torch.core.upload.HydrateStats` of the most recent
        #: hydrate_remote/hydrate_peer call (None before the first)
        self.last_hydrate_stats = None
        #: :class:`repro_torch.core.serve.TensorReadStats` of remote/peer
        #: ``load_tensor`` calls, append-only
        self.last_serve: List[object] = []
        # peer-replication tier (DESIGN.md §11): backend-agnostic — the
        # ENGINE owns the replicator and enqueues at the same
        # after-local-commit point the tiered backends upload from
        self._replicator = None
        if spec.peers:
            from repro_torch.core.peer import PeerReplicator
            self._replicator = PeerReplicator(
                spec.peers,
                replication_factor=spec.replication_factor,
                failure_domain=spec.failure_domain,
                volume_roots=self.volume_roots(),
                op_timeout=spec.peer_op_timeout)
        self._worker: Optional[_SaveWorker] = None   # started lazily
        self._inflight: List[SaveHandle] = []
        self._deferred_exc: Optional[BaseException] = None
        self._lock = threading.Lock()
        self.stats = EngineStats()
        self._warn_if_legacy_only()

    # ---------------------------------------------------------- properties
    @property
    def directory(self) -> str:
        return self.spec.directory

    @property
    def async_save(self) -> bool:
        return self._backend.async_save

    def volume_roots(self) -> List[str]:
        """Absolute destination volume roots; index == Extent.volume."""
        vols = self.spec.volumes or [self.spec.directory]
        return [os.path.abspath(v) for v in vols]

    # ---------------------------------------------------------------- save
    def save(self, state, step: int, extras: Optional[dict] = None
             ) -> SaveHandle:
        """Persist a checkpoint of ``state`` at ``step``. Returns a
        :class:`SaveHandle`; for sync backends it is already done (and
        errors raise immediately), for async backends it completes when
        the helper thread commits."""
        handle = SaveHandle(step, self.spec.backend)
        job = lambda: self._save_committed(state, step, extras,  # noqa: E731
                                           handle)
        self.stats.submitted += 1
        if self._backend.async_save:
            if self._worker is None:
                self._worker = _SaveWorker()
            self._throttle()
            with self._lock:
                self._inflight.append(handle)
            self._worker.submit(job, handle)
            return handle
        try:
            handle._finish(stats=job())      # failures counted inside job
        except BaseException as e:
            handle._finish(exc=e)
            raise
        return handle

    def _warn_if_legacy_only(self):
        """Pre-engine checkpoints (manifest.json, no COMMIT) are
        indistinguishable from torn directories, so the engine will not
        read them (DESIGN.md §4) — but silently restarting from step 0
        would be worse, so say it loudly once."""
        if layout.committed_steps(self.spec.directory, legacy_ok=False):
            return
        legacy = layout.committed_steps(self.spec.directory, legacy_ok=True)
        if legacy:
            import warnings
            warnings.warn(
                f"{self.spec.directory} contains only legacy (pre-engine, "
                f"COMMIT-less) checkpoints {legacy}; CheckpointEngine "
                f"cannot verify them and will ignore them. Load them with "
                f"the legacy checkpointer classes and re-save through the "
                f"engine (DESIGN.md §4).", stacklevel=3)

    def _prune_inflight_locked(self) -> List[SaveHandle]:
        """Drop completed handles, capturing any failure so wait() still
        re-raises it (never silently swallow a lost checkpoint)."""
        pending = []
        for h in self._inflight:
            if h.done():
                if h._exc is not None and self._deferred_exc is None:
                    self._deferred_exc = h._exc
            else:
                pending.append(h)
        self._inflight = pending
        return pending

    def _throttle(self):
        """Bound in-flight async saves (memory: each holds a snapshot)."""
        t0 = time.perf_counter()
        while True:
            with self._lock:
                pending = self._prune_inflight_locked()
                if len(pending) < self.spec.max_outstanding:
                    break
            pending[0]._done.wait()
        self.stats.stall_seconds += time.perf_counter() - t0

    def _save_committed(self, state, step: int, extras: Optional[dict],
                        handle: Optional[SaveHandle] = None) -> SaveStats:
        """The crash-atomic sharded save: stage on every volume → publish
        secondary shard dirs (fresh generation names, invisible until
        referenced) → seal (global COMMIT) → publish the primary
        (rename; THE commit point). Runs on the caller or the helper
        thread; a death at any point leaves only ignorable ``.tmp``
        debris and unreferenced shard dirs that startup sweeps."""
        root = self.spec.directory
        roots = self.volume_roots()
        primary_real = os.path.realpath(root)
        nonce = os.urandom(4).hex()
        staging = os.path.join(root, layout.staging_dir_name(step))
        final = os.path.join(root, layout.step_dir_name(step))
        # per-volume staging: volumes aliasing the primary stage into the
        # primary staging dir; others get a generation-named shard dir —
        # aliased/duplicate secondary roots share ONE generation dir, so
        # a symlinked mount never double-publishes the same name
        # volume health: a root that is gone/unwritable gets no staging
        # dir — the checkpointer's plan-time probe then stripes around
        # it (its staging path cannot be created) and the manifest
        # records the degraded set
        _, dead = probe_volumes(roots)
        dead = set(dead)
        volume_staging, secondary = [], {}    # v → (staging, final)
        gen_by_root: Dict[str, tuple] = {}    # realpath(root) → (s, f)
        for v, vr in enumerate(roots):
            real = os.path.realpath(vr)
            if real == primary_real:
                volume_staging.append(staging)
                continue
            if v in dead:
                # hand the uncreatable path down: the probe below reads
                # it as degraded; never publish/sweep on a dead root
                volume_staging.append(os.path.join(
                    vr, layout.shard_staging_dir_name(step, nonce)))
                continue
            if real not in gen_by_root:
                gen_by_root[real] = (
                    os.path.join(vr, layout.shard_staging_dir_name(step,
                                                                   nonce)),
                    os.path.join(vr, layout.shard_dir_name(step, nonce)))
            s, f = gen_by_root[real]
            secondary[v] = (s, f)
            volume_staging.append(s)
        all_staging = sorted({staging, *(s for s, _ in gen_by_root.values())})
        for d in all_staging:
            if os.path.exists(d):
                shutil.rmtree(d)
            os.makedirs(d)
        # snapshot-granular sync (DESIGN.md §10): tell the backend to
        # flip this handle's snapshot event as soon as the device→
        # staging copy lands — binding happens here (on the serial save
        # path) so queued saves never clobber each other's callback
        if handle is not None:
            self._backend.bind_snapshot(handle._mark_snapshot)
        published = False
        try:
            stats = self._backend.write_payload_sharded(
                state, step, extras, staging, volume_staging)
            t0 = time.perf_counter()
            # a volume-agnostic backend (baseline, single_file) leaves
            # its secondary staging dirs empty: drop them instead of
            # publishing and commit-recording empty generation dirs
            live = []
            for s, f in gen_by_root.values():
                if os.listdir(s):
                    live.append((s, f))
                else:
                    os.rmdir(s)
            if self.spec.fsync_commit:
                # the bytes COMMIT vouches for must be durable first —
                # otherwise power loss can keep the marker, drop the
                # data; volumes drain concurrently, one flusher per file
                layout.fsync_payloads([staging, *(s for s, _ in live)])
            if len(live) > 1:
                # publish every volume's shard dir concurrently — each
                # rename + parent fsync is an independent journal commit
                from concurrent.futures import ThreadPoolExecutor
                with ThreadPoolExecutor(len(live)) as ex:
                    list(ex.map(
                        lambda sf: layout.publish_fresh(
                            *sf, fsync=self.spec.fsync_commit), live))
            elif live:
                layout.publish_fresh(*live[0], fsync=self.spec.fsync_commit)
            live_staging = {s for s, _ in live}
            volume_dirs = {str(v): os.path.basename(f)
                           for v, (s, f) in sorted(secondary.items())
                           if s in live_staging}
            marker = layout.write_commit_marker(
                staging, step, self.spec.backend,
                fsync=self.spec.fsync_commit,
                shards=getattr(stats, "shards", None),
                volume_roots=roots if volume_dirs else None,
                volume_dirs=volume_dirs or None,
                generation=getattr(stats, "generation", "") or None,
                delta=getattr(stats, "delta", None))
            layout.publish(staging, final, fsync=self.spec.fsync_commit)
            published = True
            stats.commit_seconds = time.perf_counter() - t0
        except BaseException:
            # graceful-failure path; a SIGKILL leaves the .tmp dirs and
            # unreferenced generation dirs, which every reader ignores
            # and the next engine start sweeps
            shutil.rmtree(staging, ignore_errors=True)
            for s, f in gen_by_root.values():
                shutil.rmtree(s, ignore_errors=True)
                if not published:
                    shutil.rmtree(f, ignore_errors=True)
            self.stats.failed += 1
            raise
        # the new COMMIT supersedes any previous generation of this step:
        # older shard dirs are now unreferenced — drop them (best-effort;
        # a crash here leaves orphans for the startup sweep)
        for _, f in gen_by_root.values():
            for old in layout.shard_dirs_for_step(os.path.dirname(f), step):
                if os.path.basename(old) != os.path.basename(f):
                    shutil.rmtree(old, ignore_errors=True)
        stats.backend = self.spec.backend
        stats.step = step
        self.stats.committed += 1
        self.stats.write_seconds += stats.seconds
        self.stats.bytes_written += stats.total_bytes
        if getattr(stats, "arena_reused", False):
            self.stats.arena_reuses += 1
        # second durability tier (DESIGN.md §8): the local commit point
        # is behind us — hand the sealed generation to the backend's
        # background uploader; the ticket lands on the handle BEFORE it
        # finishes, so wait() → wait_uploaded() never races
        ticket = self._backend.after_commit(step, final, marker, stats)
        if ticket is not None:
            self.stats.uploads_enqueued += 1
            if handle is not None:
                handle._attach_upload(ticket)
        # peer tier (DESIGN.md §11): same hook point, same pre-finish
        # attach discipline — wait() → wait_replicated() never races
        if self._replicator is not None:
            rticket = self._replicator.enqueue(step, final, marker)
            self.stats.replications_enqueued += 1
            if handle is not None:
                handle._attach_replication(rticket)
        return stats

    # ---------------------------------------------------------------- sync
    def wait(self):
        """Block until every submitted save has committed (the paper's
        block-before-optimizer sync point). Re-raises the first failure.
        No-op for sync backends."""
        t0 = time.perf_counter()
        with self._lock:
            pending, self._inflight = self._inflight, []
            err, self._deferred_exc = self._deferred_exc, None
        for h in pending:
            h._done.wait()
            if err is None and h.exception() is not None:
                err = h.exception()
        self.stats.stall_seconds += time.perf_counter() - t0
        if err is not None:
            raise err

    def wait_snapshot(self):
        """Block until every in-flight save's device→host snapshot has
        landed (DESIGN.md §10) — the chunk-granular half of the paper's
        §4.3 sync point. After this, a train step may update the state
        in place while the WRITES still overlap it; full commits are
        still awaited by the save throttle, :meth:`wait` and
        :meth:`drain`. Re-raises the first
        failure of an already-failed save. No-op for sync backends."""
        t0 = time.perf_counter()
        with self._lock:
            pending = list(self._prune_inflight_locked())
            err, self._deferred_exc = self._deferred_exc, None
        for h in pending:
            h._snapshotted.wait()
            if err is None and h.done() and h._exc is not None:
                err = h._exc
                with self._lock:
                    if h in self._inflight:
                        self._inflight.remove(h)
        dt = time.perf_counter() - t0
        self.stats.stall_seconds += dt
        self.stats.snapshot_stall_seconds += dt
        if err is not None:
            raise err

    def drain(self):
        """wait() plus parking the helper thread — no thread outlives
        the work. The engine stays fully usable; the next async save
        restarts the worker."""
        try:
            self.wait()
        finally:
            if self._worker is not None:
                self._worker.close()
                self._worker = None

    def close(self):
        """Drain outstanding saves, stop the helper thread, and close
        the backend (which drains its upload tier) and the peer
        replicator."""
        try:
            self.drain()
        finally:
            try:
                self._backend.close()
            finally:
                if self._replicator is not None:
                    self._replicator.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---------------------------------------------------------------- read
    def steps(self) -> List[int]:
        """All committed steps (shallow marker check, sorted)."""
        return layout.committed_steps(self.spec.directory, legacy_ok=False)

    def latest_step(self) -> Optional[int]:
        """Most recent step that passes DEEP commit verification —
        uncommitted, torn, and stray directories are skipped, so a
        restore after a mid-save crash resumes from the last good
        checkpoint instead of exploding."""
        for step in reversed(self.steps()):
            try:
                layout.verify_commit(
                    os.path.join(self.spec.directory,
                                 layout.step_dir_name(step)), deep=True,
                    volume_roots=self.volume_roots())
                return step
            except layout.TornCheckpointError:
                continue
        return None

    def load(self, step: Optional[int] = None, like=None,
             verify: Optional[bool] = None, device=None,
             parallel=None, owned_only: bool = False,
             reader_rank: int = 0, n_readers: Optional[int] = None,
             ownership=None, tier: str = "local"):
        """Load a committed checkpoint (latest when ``step`` is None).
        Raises :class:`layout.TornCheckpointError` on an uncommitted or
        torn step — a half-written checkpoint is never silently loaded.
        The COMMIT marker records which backend wrote the payload AND
        where every shard lives, so an engine can read checkpoints
        written by a different backend, writer count, or volume layout
        (rank-elastic restore).

        ``tier="remote"`` restores THROUGH the object tier (DESIGN.md
        §8): the step (latest committed remote generation when None) is
        first hydrated into the local directory —
        missing/corrupted local shards are downloaded and CRC-verified
        against the remote COMMIT manifest, intact local ones reused —
        and then loaded through the normal (optionally parallel) local
        path. Requires ``spec.upload_store`` or a tiered backend.

        ``tier="peer"`` restores from the peer-replication tier
        (DESIGN.md §11): the newest fully-replicated chain is hydrated
        from the healthiest peer holding it, falling back to the
        remote tier when no peer can serve. Requires ``spec.peers``.

        ``like`` is the state pytree to rebuild (its leaves may be
        ``meta`` tensors); without it a flat ``{name: tensor}`` dict is
        returned. ``device`` moves every restored tensor there
        (``.to(device)``, the reference's ``sharding`` hook; a quantized
        checkpoint is dequantized there); without it the tensors are CPU
        views into the read staging.

        ``parallel`` switches to the parallel restore pipeline (paper
        §4.2 load-then-allgather, single-host form): an int (or
        ``"auto"``) drives that many local reader workers, each reading
        only its owned spans through the async read backends into one
        shared arena buffer. NOTE the arena lifetime rule (DESIGN.md
        §7): arrays from a parallel load are views into the engine's
        read arena, valid until the next load — copy (``.clone()``)
        to retain. Backends without span support ignore ``parallel``.

        ``owned_only=True`` returns this rank's
        :class:`~repro_torch.core.checkpointer.OwnedRead` instead of the full
        state — the per-rank half of a genuinely distributed restore
        (``reader_rank`` / ``n_readers`` / ``ownership`` as in
        ``load_owned``)."""
        if tier not in ("local", "peer", "remote"):
            raise ValueError(f"tier must be 'local', 'peer' or "
                             f"'remote', got {tier!r}")
        if tier == "remote":
            step = self.hydrate_remote(step)
        elif tier == "peer":
            step = self.hydrate_peer(step)
        if owned_only:
            return self.load_owned(reader_rank, n_readers, step=step,
                                   ownership=ownership, verify=verify)
        verify = self.spec.verify_on_load if verify is None else verify
        preverified = False
        if step is None:
            step = self.latest_step()       # already deep-verifies
            preverified = True
            if step is None:
                raise FileNotFoundError(
                    f"no committed checkpoint under {self.spec.directory}")
        d = os.path.join(self.spec.directory, layout.step_dir_name(step))
        if not os.path.isdir(d):
            raise FileNotFoundError(f"no checkpoint directory {d}")
        marker = (layout.read_commit_marker(d) if preverified else None)
        if marker is None:
            marker = layout.verify_commit(d, deep=verify,
                                          volume_roots=self.volume_roots())
        reader = self._reader_for(marker.get("backend", self.spec.backend))
        # only pass the parallel kwarg when actually requested, and the
        # device only to a backend that takes it: out-of-tree backends
        # registered against the pre-restore-pipeline signature must
        # keep working for plain loads (their result is moved below)
        kw = {} if parallel is None else {"parallel": parallel}
        if device is not None and _takes(reader.read_payload_sharded,
                                         "device"):
            kw["device"] = device       # a quantized payload dequantizes there
        state, manifest = reader.read_payload_sharded(
            d, step, like=like, verify=verify, marker=marker,
            volume_roots=self.volume_roots(), **kw)
        if device is not None:
            state = _to_device(state, device)
        return state, manifest

    def load_owned(self, reader_rank: int, n_readers: Optional[int] = None,
                   step: Optional[int] = None, ownership=None,
                   verify: Optional[bool] = None):
        """One DP rank's half of the distributed parallel restore: read
        ONLY the spans ``reader_rank`` owns (``ownership=None`` →
        balanced byte stripe; ``"zero1"`` → the ZeRO-1 projection from
        ``repro_torch.sharding.specs.zero1_ownership``; a dict → explicit).
        ``n_readers`` defaults to the configured DP degree. Returns an
        :class:`~repro_torch.core.checkpointer.OwnedRead`; on a real DP group
        each rank runs this, then one allgather
        (``checkpointer.allgather_owned`` is the single-host stand-in)
        rebuilds the stream."""
        verify = self.spec.verify_on_load if verify is None else verify
        if n_readers is None:
            n_readers = max(1, self.spec.fp.topology.dp_degree)
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no committed checkpoint under {self.spec.directory}")
        d = os.path.join(self.spec.directory, layout.step_dir_name(step))
        marker = layout.verify_commit(d, deep=verify,
                                      volume_roots=self.volume_roots())
        reader = self._reader_for(marker.get("backend", self.spec.backend))
        if not hasattr(reader, "read_owned"):
            raise NotImplementedError(
                f"backend {marker.get('backend')!r} has no owned-span "
                f"read support")
        return reader.read_owned(d, step, reader_rank, n_readers,
                                 ownership=ownership, verify=verify,
                                 marker=marker,
                                 volume_roots=self.volume_roots())

    def invalidate_arena(self):
        """Drop the serialize arena's cached layout when the state object
        was replaced (restore, re-init), instead of relying on the
        structure key alone."""
        self._backend.invalidate_arena()
        for b in self._read_backends.values():
            if b is not self._backend:
                b.invalidate_arena()

    def load_tensor(self, name: str, step: Optional[int] = None,
                    tier: str = "local", device=None):
        """Partial restore of one tensor by manifest name, reading only
        the byte spans the global index maps it to — across however many
        shards/volumes the writer striped it onto.

        ``tier="remote"`` / ``tier="peer"`` (DESIGN.md §12) serve the
        tensor STRAIGHT from the object/peer tier — no local
        checkpoint, no hydration: the spans are range-fetched (through
        the serving read cache when ``spec.serve_cache_mb > 0``) and
        decoded, so an inference worker pulls one embedding slice or
        expert for a fraction of the checkpoint's bytes. Wire
        accounting lands in ``engine.last_serve``. The peer tier scans
        peers healthiest-first and falls back to the remote store.

        ``device`` moves the tensor there (``.to(device)``); without it
        the tensor stays on the CPU."""
        if tier not in ("local", "peer", "remote"):
            raise ValueError(f"tier must be 'local', 'peer' or "
                             f"'remote', got {tier!r}")
        if tier == "remote":
            store = self.remote_store
            if store is None:
                raise ValueError(
                    "load_tensor(tier='remote') needs an object store: "
                    "set CheckpointSpec.upload_store or use a "
                    "fastpersist-tiered backend")
            from repro_torch.core.serve import load_tensor_remote
            return load_tensor_remote(store, name, step=step,
                                      cache=self.serve_cache,
                                      stats_out=self.last_serve,
                                      device=device)
        if tier == "peer":
            rep = self._replicator
            if rep is None:
                raise ValueError(
                    "load_tensor(tier='peer') needs a peer tier: set "
                    "CheckpointSpec.peers")
            from repro_torch.core.serve import load_tensor_remote
            miss = None
            for _pname, pstore in rep.ordered_restore_peers():
                try:
                    return load_tensor_remote(pstore, name, step=step,
                                              cache=self.serve_cache,
                                              stats_out=self.last_serve,
                                              device=device)
                except FileNotFoundError as e:
                    miss = e                 # peer has no such step
                except OSError as e:
                    miss = e                 # unreachable peer: next
            if self.remote_store is not None:
                return self.load_tensor(name, step=step, tier="remote",
                                        device=device)
            raise FileNotFoundError(
                f"no peer can serve tensor {name!r}"
                f"{f' of step {step}' if step is not None else ''}"
                f" ({miss})")
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no committed checkpoint under {self.spec.directory}")
        d = os.path.join(self.spec.directory, layout.step_dir_name(step))
        marker = layout.verify_commit(d, deep=False)
        reader = self._reader_for(marker.get("backend", self.spec.backend))
        if not hasattr(reader, "load_tensor"):
            raise NotImplementedError(
                f"backend {marker.get('backend')!r} has no partial-read "
                f"support")
        out = reader.load_tensor(d, step, name, marker=marker,
                                 volume_roots=self.volume_roots())
        return out if device is None else out.to(device)

    # ---------------------------------------------------------- tiered
    @property
    def upload_manager(self):
        """The tiered backend's :class:`repro_torch.core.upload.UploadManager`
        (None for backends without an upload tier)."""
        return getattr(self._backend, "uploader", None)

    @property
    def remote_store(self):
        """The resolved :class:`repro_torch.core.upload.ObjectStore` of the
        second tier — the tiered backend's own store, or one built from
        ``spec.upload_store`` for non-tiered backends (so any engine
        can *read* the remote tier); None when no store is configured."""
        mgr = self.upload_manager
        if mgr is not None:
            return mgr.store
        if self.spec.upload_store is None:
            return None
        if self._remote_store is None:
            from repro_torch.core.upload import make_store
            self._remote_store = make_store(self.spec.upload_store)
        return self._remote_store

    @property
    def serve_cache(self):
        """The engine's :class:`repro_torch.core.serve.ReadCache` (DESIGN.md
        §12) at ``<directory>/.serve-cache``, built lazily from
        ``spec.serve_cache_mb``; None when the cache is disabled (the
        default). Digest-keyed, so its blocks are valid across steps,
        generations, peers, and engine restarts."""
        if self.spec.serve_cache_mb <= 0:
            return None
        if self._serve_cache is None:
            from repro_torch.core.serve import ReadCache
            self._serve_cache = ReadCache(
                os.path.join(self.spec.directory, ".serve-cache"),
                max_bytes=int(self.spec.serve_cache_mb) << 20)
        return self._serve_cache

    def wait_uploaded(self):
        """Block until every enqueued upload reached its remote COMMIT
        (the remote-tier analogue of :meth:`wait`); re-raises the first
        upload failure. Returns the drained uploads'
        :class:`repro_torch.core.upload.UploadStats` (empty for non-tiered
        backends)."""
        mgr = self.upload_manager
        return mgr.drain() if mgr is not None else []

    def remote_steps(self) -> List[int]:
        """Steps with a committed generation in the object tier."""
        store = self.remote_store
        if store is None:
            return []
        from repro_torch.core import upload
        return upload.remote_steps(store)

    def latest_remote_step(self) -> Optional[int]:
        steps = self.remote_steps()
        return steps[-1] if steps else None

    def hydrate_remote(self, step: Optional[int] = None,
                       readers: Optional[int] = None) -> int:
        """Materialise a remote generation locally (download + CRC
        verification + crash-atomic local re-commit; intact local shard
        files are reused). The missing bytes are range-fetched
        ``spec.hydrate_readers`` wide (override with ``readers``)
        through the serving read cache when enabled; byte accounting
        lands in ``engine.last_hydrate_stats``. Returns the hydrated
        step. ``load(tier="remote")`` calls this before the normal
        local load."""
        store = self.remote_store
        if store is None:
            raise ValueError(
                "load(tier='remote') needs an object store: set "
                "CheckpointSpec.upload_store or use a fastpersist-tiered "
                "backend")
        from repro_torch.core.upload import HydrateStats, hydrate
        self.last_hydrate_stats = HydrateStats()
        return hydrate(store, self.spec.directory, step=step,
                       io_config=self.spec.fp.writer,
                       verify=self.spec.verify_on_load,
                       readers=(self.spec.hydrate_readers
                                if readers is None else readers),
                       cache=self.serve_cache,
                       stats=self.last_hydrate_stats)

    # ------------------------------------------------------------ peer tier
    @property
    def peer_replicator(self):
        """The engine's :class:`repro_torch.core.peer.PeerReplicator` (None
        when ``spec.peers`` is unset)."""
        return self._replicator

    def wait_replicated(self):
        """Block until every enqueued replication finished on the peer
        tier (the peer analogue of :meth:`wait_uploaded`); re-raises
        the first replication failure. Returns the drained jobs'
        :class:`repro_torch.core.peer.ReplicationStats` (empty without a
        peer tier)."""
        rep = self._replicator
        return rep.drain() if rep is not None else []

    def unreplicated_steps(self) -> List[int]:
        """Steps not yet durable at the full replication target —
        the peer tier's retention pin set (empty without one)."""
        rep = self._replicator
        return rep.unreplicated_steps() if rep is not None else []

    def peer_status(self) -> List[dict]:
        """Per-peer health snapshot (empty without a peer tier)."""
        rep = self._replicator
        return rep.peer_status() if rep is not None else []

    def hydrate_peer(self, step: Optional[int] = None,
                     readers: Optional[int] = None) -> int:
        """Restore-from-peer failover (DESIGN.md §11): rebuild the
        local checkpoint from the newest FULLY-replicated chain on the
        healthiest peer (CRC-verified, crash-atomic local re-commit),
        falling back to the remote tier when no peer holds a complete
        chain, and raising only when neither tier can serve. Returns
        the hydrated step. ``load(tier="peer")`` calls this first."""
        rep = self._replicator
        if rep is None:
            raise ValueError(
                "load(tier='peer') needs a peer tier: set "
                "CheckpointSpec.peers")
        from repro_torch.core.upload import HydrateStats
        self.last_hydrate_stats = HydrateStats()
        try:
            return rep.hydrate(self.spec.directory, step=step,
                               io_config=self.spec.fp.writer,
                               verify=self.spec.verify_on_load,
                               readers=(self.spec.hydrate_readers
                                        if readers is None else readers),
                               cache=self.serve_cache,
                               stats=self.last_hydrate_stats)
        except FileNotFoundError as peer_miss:
            if self.remote_store is None:
                raise
            import warnings
            warnings.warn(
                f"peer tier cannot serve the restore ({peer_miss}); "
                f"falling back to the remote tier", stacklevel=2)
            return self.hydrate_remote(step, readers=readers)

    #: read-path aliases: these backends share the fastpersist on-disk
    #: format, so loading THEIR checkpoints never needs their write-side
    #: machinery (a tiered reader would demand an upload store; the
    #: pipelined one would spin a pointless helper thread)
    _READ_ALIASES = {
        "fastpersist-pipelined": "fastpersist",
        "fastpersist-tiered": "fastpersist",
        "fastpersist-tiered-pipelined": "fastpersist",
    }

    def _reader_for(self, backend_name: str) -> CheckpointBackend:
        if backend_name not in self._read_backends:
            alias = self._READ_ALIASES.get(backend_name, backend_name)
            if alias not in self._read_backends:
                self._read_backends[alias] = \
                    get_backend_factory(alias)(self.spec)
            self._read_backends[backend_name] = self._read_backends[alias]
        return self._read_backends[backend_name]


def _takes(fn, name: str) -> bool:
    """Whether ``fn`` accepts the keyword argument ``name``."""
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False
    return name in params or any(p.kind is p.VAR_KEYWORD
                                 for p in params.values())


def _to_device(state, device):
    """``.to(device)`` every restored tensor (the reference's
    ``_apply_sharding``); a flat ``{name: tensor}`` dict round-trips too,
    its keys being its leaf names."""
    return unflatten(state, {n: t.to(device) for n, t in flatten(state)})
