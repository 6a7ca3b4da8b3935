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
:mod:`repro_torch.core.layout`) and the same snapshot-granular sync
point. Restored tensors are placed with ``.to(device)``.

Not ported yet, and raising ``NotImplementedError``: the durability
tiers — the ``fastpersist-tiered`` backends, ``upload_store``, the peer
tier and the serving read cache (ROADMAP.md queue A item 5) — and the
per-rank owned reads of ``load_owned`` (queue A item 2).
"""
from __future__ import annotations

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

_TIERS_TODO = ("the durability tiers (object-store upload, peer "
               "replication, serving read cache) are not ported yet: "
               "ROADMAP.md queue A item 5")
_OWNED_TODO = ("owned-span reads (load_owned / owned_only, ZeRO-1 "
               "ownership) are not ported yet: ROADMAP.md queue A item 2")


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
    #: durability tiers of the reference (DESIGN.md §8, §11, §12), kept
    #: so a spec carries over; setting one raises NotImplementedError
    upload_store: Optional[object] = None
    peers: Optional[Sequence[object]] = None
    serve_cache_mb: int = 0


# ================================================================== handle
class SaveHandle:
    """Future for one checkpoint save. Sync backends hand back handles
    that are already done; async backends complete them from the helper
    thread. ``wait``/``result`` re-raise the save's exception."""

    def __init__(self, step: int, backend: str):
        self.step = step
        self.backend = backend
        self._done = threading.Event()
        self._snapshotted = threading.Event()
        self._stats: Optional[SaveStats] = None
        self._exc: Optional[BaseException] = None

    def _finish(self, stats: Optional[SaveStats] = None,
                exc: Optional[BaseException] = None):
        self._stats, self._exc = stats, exc
        # a finished save's snapshot is trivially over (success OR
        # failure) — nobody may hang in wait_snapshot
        self._snapshotted.set()
        self._done.set()

    def _mark_snapshot(self):
        # backend callback (bind_snapshot): the device→staging copy has
        # fully landed; the write may still be in flight
        self._snapshotted.set()

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> SaveStats:
        """Block until the LOCAL commit completed; returns the save's
        unified :class:`SaveStats` or re-raises its failure."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"save of step {self.step} still in flight")
        if self._exc is not None:
            raise self._exc
        return self._stats

    result = wait

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
        for volume ``v`` (may alias ``directory``). Volume-agnostic
        backends inherit this default."""
        return self.write_payload(state, step, extras, directory)

    def read_payload(self, directory: str, step: int, like=None,
                     verify: bool = True) -> Tuple[object, object]:
        raise NotImplementedError

    def read_payload_sharded(self, directory: str, step: int, like=None,
                             verify: bool = True, marker=None,
                             volume_roots=None,
                             parallel=None) -> Tuple[object, object]:
        """Multi-volume read hook; the default ignores the shard context
        and the parallel-restore request."""
        return self.read_payload(directory, step, like=like, verify=verify)

    def invalidate_arena(self):
        """Drop any cached serialize-arena layout (the trainer calls this
        when the state object was replaced). Default: nothing cached."""

    def bind_snapshot(self, callback):
        """Install the one-shot snapshot-complete callback for the NEXT
        save (DESIGN.md §10). Backends without a distinct snapshot stage
        ignore it — the engine then treats snapshot-done as save-done."""

    def after_commit(self, step: int, directory: str, marker: dict,
                     stats: SaveStats):
        """Post-publish hook, called by the engine AFTER the local
        crash-atomic rename with the published ``directory`` and its
        COMMIT ``marker``."""

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
                             parallel=None):
        return self._inner.load(step, like=like, verify=verify,
                                directory=directory, marker=marker,
                                volume_roots=volume_roots,
                                read_plan=parallel)

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
        # as a delta base once its COMMIT actually published
        self._inner.note_committed(step, marker)


class PipelinedFastPersistBackend(FastPersistBackend):
    """Paper §4.3: same write path, persisted by the engine's helper
    thread so it overlaps the next iteration's forward/backward."""
    async_save = True


def _tiered_backend(spec: CheckpointSpec) -> CheckpointBackend:
    """``fastpersist-tiered[-pipelined]``: registered under the
    reference's keys so their COMMIT markers resolve (reads go through
    the fastpersist alias), but writing through them is not ported."""
    raise NotImplementedError(_TIERS_TODO)


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
    """Register a checkpoint backend under a string key (what
    ``CheckpointSpec.backend``, the launcher's ``--backend`` and COMMIT
    markers refer to)."""
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"backend {name!r} already registered "
                         f"(pass overwrite=True to replace)")
    _REGISTRY[name] = factory


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
register_backend("fastpersist-tiered", _tiered_backend)
register_backend("fastpersist-tiered-pipelined", _tiered_backend)


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


class CheckpointEngine:
    """Facade over every checkpointing mode. One save path, one load
    path, one on-disk layout — regardless of backend."""

    def __init__(self, spec: CheckpointSpec):
        if spec.upload_store is not None or spec.peers \
                or spec.serve_cache_mb > 0:
            raise NotImplementedError(_TIERS_TODO)
        self.spec = spec
        os.makedirs(spec.directory, exist_ok=True)
        for root in self.volume_roots():
            try:
                os.makedirs(root, exist_ok=True)
            except OSError as e:
                # a dead volume must not kill the engine: the per-save
                # health probe stripes around it
                import warnings
                warnings.warn(f"checkpoint volume root {root} is "
                              f"unavailable ({e}); saves will stripe "
                              f"around it", stacklevel=2)
        if spec.clean_stale_staging:
            layout.clean_stale_multi(spec.directory, self.volume_roots())
        self._backend = get_backend_factory(spec.backend)(spec)
        self._read_backends: Dict[str, CheckpointBackend] = {
            spec.backend: self._backend}
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
        read them (DESIGN.md §4) — say so loudly once."""
        if layout.committed_steps(self.spec.directory, legacy_ok=False):
            return
        legacy = layout.committed_steps(self.spec.directory, legacy_ok=True)
        if legacy:
            import warnings
            warnings.warn(
                f"{self.spec.directory} contains only legacy (pre-engine, "
                f"COMMIT-less) checkpoints {legacy}; CheckpointEngine "
                f"cannot verify them and will ignore them (DESIGN.md §4).",
                stacklevel=3)

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
        (rename; THE commit point). A death at any point leaves only
        ignorable ``.tmp`` debris and unreferenced shard dirs that
        startup sweeps."""
        root = self.spec.directory
        roots = self.volume_roots()
        primary_real = os.path.realpath(root)
        nonce = os.urandom(4).hex()
        staging = os.path.join(root, layout.staging_dir_name(step))
        final = os.path.join(root, layout.step_dir_name(step))
        # per-volume staging: volumes aliasing the primary stage into the
        # primary staging dir; others get a generation-named shard dir;
        # a dead root gets no staging dir (the plan-time probe stripes
        # around it and the manifest records it as degraded)
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
        # snapshot-granular sync (DESIGN.md §10): binding happens here
        # (on the serial save path) so queued saves never clobber each
        # other's callback
        if handle is not None:
            self._backend.bind_snapshot(handle._mark_snapshot)
        published = False
        try:
            stats = self._backend.write_payload_sharded(
                state, step, extras, staging, volume_staging)
            t0 = time.perf_counter()
            # a volume-agnostic backend (baseline, single_file) leaves
            # its secondary staging dirs empty: drop them
            live = []
            for s, f in gen_by_root.values():
                if os.listdir(s):
                    live.append((s, f))
                else:
                    os.rmdir(s)
            if self.spec.fsync_commit:
                # the bytes COMMIT vouches for must be durable first
                layout.fsync_payloads([staging, *(s for s, _ in live)])
            if len(live) > 1:
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
            shutil.rmtree(staging, ignore_errors=True)
            for s, f in gen_by_root.values():
                shutil.rmtree(s, ignore_errors=True)
                if not published:
                    shutil.rmtree(f, ignore_errors=True)
            self.stats.failed += 1
            raise
        # the new COMMIT supersedes any previous generation of this step
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
        self._backend.after_commit(step, final, marker, stats)
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
        in place while the WRITES still overlap it. Re-raises the first
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
        the work. The next async save restarts the worker."""
        try:
            self.wait()
        finally:
            if self._worker is not None:
                self._worker.close()
                self._worker = None

    def close(self):
        """Drain outstanding saves, stop the helper thread, and close
        the backend."""
        try:
            self.drain()
        finally:
            self._backend.close()

    # ---------------------------------------------------------------- read
    def steps(self) -> List[int]:
        """All committed steps (shallow marker check, sorted)."""
        return layout.committed_steps(self.spec.directory, legacy_ok=False)

    def latest_step(self) -> Optional[int]:
        """Most recent step that passes DEEP commit verification —
        uncommitted, torn, and stray directories are skipped."""
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
             tier: str = "local"):
        """Load a committed checkpoint (latest when ``step`` is None).
        Raises :class:`layout.TornCheckpointError` on an uncommitted or
        torn step. The COMMIT marker records which backend wrote the
        payload AND where every shard lives, so an engine reads
        checkpoints written by another backend, writer count, volume
        layout — or package (rank-elastic restore).

        ``like`` is the state pytree to rebuild (its leaves may be
        ``meta`` tensors); without it a flat ``{name: tensor}`` dict is
        returned. ``device`` moves every restored tensor there
        (``.to(device)``, the reference's ``sharding`` hook); without it
        the tensors are CPU views into the read staging (arena lifetime
        rule, DESIGN.md §7: copy to retain past the next load).

        ``parallel`` switches to the parallel restore pipeline (paper
        §4.2): an int (or ``"auto"``) drives that many local reader
        workers. Only the local tier is ported."""
        if tier != "local":
            raise NotImplementedError(_TIERS_TODO)
        if owned_only:
            raise NotImplementedError(_OWNED_TODO)
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
        kw = {} if parallel is None else {"parallel": parallel}
        state, manifest = reader.read_payload_sharded(
            d, step, like=like, verify=verify, marker=marker,
            volume_roots=self.volume_roots(), **kw)
        if device is not None:
            state = _to_device(state, device)
        return state, manifest

    def load_owned(self, *args, **kwargs):
        """The reference's per-rank owned-span restore: not ported."""
        raise NotImplementedError(_OWNED_TODO)

    def invalidate_arena(self):
        """Drop the serialize arena's cached layout when the state object
        was replaced (restore, re-init), instead of relying on the
        structure key alone."""
        self._backend.invalidate_arena()
        for b in self._read_backends.values():
            if b is not self._backend:
                b.invalidate_arena()

    def load_tensor(self, name: str, step: Optional[int] = None,
                    tier: str = "local"):
        """Partial restore of one tensor by manifest name, reading only
        the byte spans the global index maps it to — across however many
        shards/volumes the writer striped it onto. Only the local tier is
        ported."""
        if tier != "local":
            raise NotImplementedError(_TIERS_TODO)
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
        return reader.load_tensor(d, step, name, marker=marker,
                                  volume_roots=self.volume_roots())

    #: read-path aliases: these backends share the fastpersist on-disk
    #: format, so loading THEIR checkpoints never needs their write-side
    #: machinery
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


def _to_device(state, device):
    """``.to(device)`` every restored tensor (the reference's
    ``_apply_sharding``); a flat ``{name: tensor}`` dict round-trips too,
    its keys being its leaf names."""
    return unflatten(state, {n: t.to(device) for n, t in flatten(state)})
