"""Peer-replication durability tier (DESIGN.md §11; after Checkmate's
near-zero-overhead replication over the training network and
Check-N-Run's decoupled persist stage).

Per-iteration checkpointing (the paper's thesis) only buys fault
tolerance if a checkpoint survives the node that wrote it — and before
this module the first OFF-NODE durability point was the object store
(``wait_uploaded()``), a WAN round-trip away. The peer tier sits
between local NVMe and the object store: after the local COMMIT
rename, a :class:`PeerReplicator` background worker streams the sealed
generation — keyframes AND delta generations (striped or
single-stream, DESIGN.md §13: shards come from the COMMIT's shard
list), walking ``delta_base`` chains so every replicated delta stays
replayable — to K peer nodes' RAM/NVMe over the training network:

    tier ordering:   local NVMe  →  peer RAM/NVMe  →  object store
    sync points:     wait()         wait_replicated()  wait_uploaded()

Peers are :class:`~repro_torch.core.upload.ObjectStore` endpoints (the
``register_store_scheme`` hook binds real transports; tests/CI and
single-host runs use the filesystem-backed mock), and the on-peer
layout is EXACTLY the remote tier's: idempotent content-derived
``ckpt_<step>.gen-<nonce>/`` generation prefixes, per-shard size+CRC
skip on retry, the peer ``COMMIT`` object written strictly LAST. A
peer generation is unobservable until its COMMIT lands, so a
replicator death mid-stream never leaves a loadable-looking torn copy,
and :func:`repro_torch.core.upload.hydrate` restores from a peer unchanged.

Robustness core:

  * **failure-domain-aware placement** — each peer declares a
    ``failure_domain`` (rack/PSU/switch); placement never targets the
    writer's own domain while any other usable domain exists, and
    spreads the K replicas over K distinct domains when available.
  * **health tracking** — per-peer consecutive-failure ejection with
    probation re-admission: an ejected peer is skipped until
    ``probation_seconds`` elapse, then offered ONE trial replication;
    success re-admits it, failure re-ejects and restarts the clock.
  * **graceful degradation** — with fewer than K usable peers, saves
    complete against the K' survivors and the under-replication is
    reported loudly (``ReplicatorTotals.under_replicated_saves``, a
    one-shot ``warnings.warn`` per degradation level) instead of
    blocking training. Zero surviving peers fails the replication —
    a FAILED replication never reports durable.
  * **bounded I/O** — every peer operation runs under the shared
    retry discipline (:mod:`repro_torch.core.retry`): exponential backoff +
    full jitter + a per-attempt deadline, so one wedged peer can
    never stall the worker forever.

Restore (``engine.load(tier="peer")``): a node that lost its local
directory hydrates the newest FULLY-replicated chain — every link
committed on one peer — from the healthiest peer holding it,
CRC-verified through :func:`repro_torch.core.reader.read_stream`, falling
back peer → remote → raise.

A copy of ``repro.core.peer``: peers hold the reference's remote
generation format, so a peer directory either package filled restores
through the other.
"""
from __future__ import annotations

import json
import os
import queue
import threading
import time
import warnings
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core import layout, retry
from repro_torch.core.upload import (ObjectStore, REMOTE_COMMIT, cas_key,
                               entry_digest, hydrate, make_store,
                               prune_store, read_remote_commit,
                               remote_generations, remote_prefix,
                               remote_generation, remote_steps)


class ReplicationError(IOError):
    """A generation could not be committed to ANY peer."""


# ============================================================== peers
@dataclass
class PeerConfig:
    """One replication target: a peer node's RAM/NVMe endpoint.

    Attributes:
        name: stable peer identity (health tracking, stats, logs).
        store: the peer's :class:`ObjectStore` endpoint — an instance,
            a path / ``file://`` URL (mock), or a registered
            ``scheme://`` URL (real transport).
        failure_domain: the failure domain this peer shares power/
            network with (rack id, host id, ...). Placement never
            co-locates a replica with the writer's own domain while
            another usable domain exists. Empty = unknown (treated as
            its own singleton domain).
    """
    name: str
    store: Union[str, ObjectStore]
    failure_domain: str = ""


def make_peer(spec: Union[str, PeerConfig]) -> PeerConfig:
    """Resolve a peer spec. A :class:`PeerConfig` passes through; a
    string is ``[name=]store[@domain]`` — e.g. ``/mnt/peers/n1@rack0``
    or ``n1=peer://10.0.0.1@rack0``. The ``@domain`` suffix is only
    split off when it contains no path separator, so plain paths with
    ``@`` deeper inside survive."""
    if isinstance(spec, PeerConfig):
        return spec
    if not isinstance(spec, str) or not spec:
        raise TypeError(f"peer spec must be a PeerConfig or a "
                        f"'[name=]store[@domain]' string, got {spec!r}")
    name = ""
    if "=" in spec.split("://", 1)[0].split("/", 1)[0]:
        name, spec = spec.split("=", 1)
    store, domain = spec, ""
    if "@" in spec:
        head, tail = spec.rsplit("@", 1)
        if tail and "/" not in tail:
            store, domain = head, tail
    return PeerConfig(name=name or store, store=store,
                      failure_domain=domain)


class PeerHealth:
    """Per-peer health state machine (DESIGN.md §11)::

        healthy --[eject_after consecutive failures]--> ejected
        ejected --[probation_seconds elapse]----------> probation
        probation --success--> healthy     (counters reset)
        probation --failure--> ejected     (probation clock restarts)

    A peer in probation is offered work again, but ONE failure
    re-ejects it immediately (no fresh consecutive-failure budget), so
    a flapping peer converges to mostly-ejected instead of eating a
    full failure budget per flap."""

    def __init__(self, eject_after: int = 3,
                 probation_seconds: float = 30.0):
        self.eject_after = max(int(eject_after), 1)
        self.probation_seconds = probation_seconds
        self.consecutive_failures = 0
        self.failures = 0
        self.successes = 0
        self.ejected_at: Optional[float] = None
        self.last_error: str = ""

    def state(self, now: Optional[float] = None) -> str:
        if self.ejected_at is None:
            return "healthy"
        now = time.monotonic() if now is None else now
        if now - self.ejected_at >= self.probation_seconds:
            return "probation"
        return "ejected"

    def usable(self, now: Optional[float] = None) -> bool:
        return self.state(now) != "ejected"

    def record_success(self):
        self.successes += 1
        self.consecutive_failures = 0
        self.ejected_at = None
        self.last_error = ""

    def record_failure(self, error: str = "",
                       now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        self.failures += 1
        self.last_error = error
        if self.ejected_at is not None:
            # failing its probation trial: re-eject, restart the clock
            self.ejected_at = now
            return
        self.consecutive_failures += 1
        if self.consecutive_failures >= self.eject_after:
            self.ejected_at = now


class _Peer:
    """Bound (config, resolved store, health) triple."""

    def __init__(self, cfg: PeerConfig, eject_after: int,
                 probation_seconds: float):
        self.cfg = cfg
        self.store = make_store(cfg.store)
        self.health = PeerHealth(eject_after, probation_seconds)

    @property
    def name(self) -> str:
        return self.cfg.name

    @property
    def domain(self) -> str:
        # an unknown domain must never alias other unknown domains
        # into one (that would forbid using two un-labelled peers
        # together), so it becomes a singleton keyed by peer name
        return self.cfg.failure_domain or f"peer:{self.cfg.name}"


# =============================================================== stats
@dataclass
class PeerReplicaResult:
    """Outcome of one generation chain on ONE peer."""
    peer: str
    ok: bool = False
    n_uploaded: int = 0
    n_skipped: int = 0
    bytes_sent: int = 0
    error: str = ""


@dataclass
class ReplicationStats:
    """Outcome of one save's replication job
    (``SaveHandle.wait_replicated`` returns this)."""
    step: int
    generation: str = ""
    chain_len: int = 1          # generations shipped (delta chain depth)
    target: int = 0             # replicas placement aimed for
    replicas: int = 0           # peers holding the full committed chain
    n_objects: int = 0          # payload objects per replica
    bytes_sent: int = 0         # across all peers, actually transferred
    retries: int = 0
    attempts: int = 0
    backoff_seconds: float = 0.0
    seconds: float = 0.0
    committed: bool = False     # >= 1 peer committed the whole chain
    under_replicated: bool = False    # replicas < target at completion
    per_peer: List[PeerReplicaResult] = field(default_factory=list)


@dataclass
class ReplicatorTotals:
    """Aggregate replicator accounting (the loud under-replication
    stat lives here)."""
    replications: int = 0            # jobs that committed to >= 1 peer
    failed: int = 0                  # jobs that committed to NO peer
    under_replicated_saves: int = 0  # jobs finishing below target
    bytes_sent: int = 0
    retries: int = 0
    backoff_seconds: float = 0.0
    seconds: float = 0.0
    ejections: int = 0               # health transitions into ejected


class ReplicationTicket:
    """Future for one enqueued replication job; ``wait(timeout)`` is
    ONE budget across all K peer transfers (they run concurrently and
    the job completes only when every per-peer outcome is known)."""

    def __init__(self, step: int):
        self.step = step
        self._done = threading.Event()
        self._stats: Optional[ReplicationStats] = None
        self._exc: Optional[BaseException] = None

    def _finish(self, stats: Optional[ReplicationStats] = None,
                exc: Optional[BaseException] = None):
        self._stats, self._exc = stats, exc
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> ReplicationStats:
        if not self._done.wait(timeout):
            raise TimeoutError(f"replication of step {self.step} still "
                               f"in flight")
        if self._exc is not None:
            raise self._exc
        return self._stats

    result = wait

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        if not self._done.wait(timeout):
            raise TimeoutError(f"replication of step {self.step} still "
                               f"in flight")
        return self._exc

    def __repr__(self):
        st = "done" if self.done() else "pending"
        return f"ReplicationTicket(step={self.step}, {st})"


# ============================================================ manager
class PeerReplicator:
    """Background worker replicating sealed generations to K peers.

    Mirrors :class:`~repro_torch.core.upload.UploadManager`'s queue
    discipline — enqueue after the local COMMIT rename, single worker
    thread, tickets as futures, pinned-until-durable retention
    interplay — with the peer-tier robustness core on top (placement,
    health, degradation; module docstring).

    A step counts as *unreplicated* (pinned against local GC, see
    :meth:`unreplicated_steps`) from enqueue until a job committed its
    chain to the FULL placement target: failed jobs stay pinned, and
    so do under-replicated ones — K' < K replicas is durable enough to
    restart from, not durable enough to delete the local copy over.
    """

    def __init__(self, peers: Sequence[Union[str, PeerConfig]],
                 replication_factor: int = 2,
                 failure_domain: Optional[str] = None,
                 volume_roots: Optional[Sequence[str]] = None,
                 retry_policy: Optional[retry.RetryPolicy] = None,
                 op_timeout: Optional[float] = 30.0,
                 eject_after: int = 3,
                 probation_seconds: float = 30.0,
                 verify_skips: bool = True):
        cfgs = [make_peer(p) for p in peers]
        if not cfgs:
            raise ValueError("PeerReplicator needs at least one peer")
        names = [c.name for c in cfgs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate peer names: {sorted(names)}")
        self.peers = [_Peer(c, eject_after, probation_seconds)
                      for c in cfgs]
        self.replication_factor = max(int(replication_factor), 1)
        self.failure_domain = failure_domain or ""
        self.volume_roots = (list(volume_roots) if volume_roots else None)
        self.retry_policy = retry_policy or retry.RetryPolicy(
            max_retries=2, base_backoff=0.05, attempt_timeout=op_timeout)
        self.op_timeout = op_timeout
        self.verify_skips = verify_skips
        self._q: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._pending: Dict[int, int] = {}   # step → enqueued-not-done
        self._failed: Dict[int, int] = {}    # step → zero-replica jobs
        self._under: Dict[int, int] = {}     # step → replicas (< target)
        self._tickets: List[ReplicationTicket] = []
        self._warned_level: Optional[Tuple[int, int]] = None
        self.totals = ReplicatorTotals()
        self._t: Optional[threading.Thread] = None

    # ---------------------------------------------------------- submit
    def enqueue(self, step: int, directory: str,
                marker: Optional[dict] = None) -> ReplicationTicket:
        """Queue one committed checkpoint for peer replication.

        Args:
            step: the checkpoint step.
            directory: its PUBLISHED primary directory.
            marker: the parsed local COMMIT marker; read from
                ``directory`` when omitted.

        Returns:
            a :class:`ReplicationTicket`; ``wait()`` yields the
            :class:`ReplicationStats` once every per-peer outcome is
            known (one timeout budget across all K peers).
        """
        if marker is None:
            marker = layout.verify_commit(directory, deep=False)
        ticket = ReplicationTicket(step)
        with self._lock:
            self._pending[step] = self._pending.get(step, 0) + 1
            self._tickets.append(ticket)
            self._start_locked()
        self._q.put(("replicate", step, directory, marker, ticket))
        return ticket

    def enqueue_prune(self, keep_last: int,
                      on_done=None) -> ReplicationTicket:
        """Queue a peer-retention sweep (:meth:`prune_peers`) on the
        worker thread — the training thread must never block on peer
        lists/deletes. ``on_done`` (if given) is called from the worker
        with the pruned step list; the ticket's ``wait()`` yields it."""
        ticket = ReplicationTicket(step=-1)
        with self._lock:
            self._tickets.append(ticket)
            self._start_locked()
        self._q.put(("prune", keep_last, on_done, ticket))
        return ticket

    def _start_locked(self):
        if self._t is None:
            self._t = threading.Thread(target=self._run, daemon=True,
                                       name="ckpt-peer-replicator")
            self._t.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if item[0] == "prune":
                _, keep_last, on_done, ticket = item
                try:
                    victims = self.prune_peers(keep_last)
                    if on_done is not None:
                        on_done(victims)
                except BaseException as e:
                    ticket._finish(exc=e)
                else:
                    ticket._finish(stats=victims)
                continue
            _, step, directory, marker, ticket = item
            try:
                stats = self._replicate_one(step, directory, marker)
            except BaseException as e:
                with self._lock:
                    self._consume_pending(step)
                    # zero replicas: the local copy may be the only
                    # off-nothing copy — stays pinned through _failed
                    self._failed[step] = self._failed.get(step, 0) + 1
                    self.totals.failed += 1
                ticket._finish(exc=e)
            else:
                with self._lock:
                    self._consume_pending(step)
                    self._failed.pop(step, None)
                    if stats.under_replicated:
                        self._under[step] = stats.replicas
                    else:
                        self._under.pop(step, None)
                ticket._finish(stats=stats)

    def _consume_pending(self, step: int):
        # caller holds self._lock
        n = self._pending.get(step, 1) - 1
        if n <= 0:
            self._pending.pop(step, None)
        else:
            self._pending[step] = n

    # --------------------------------------------------------- placement
    def place(self, now: Optional[float] = None) -> List[_Peer]:
        """Choose up to ``replication_factor`` peers for one job.

        Placement rule (DESIGN.md §11): usable peers (healthy or
        probation-due) OUTSIDE the writer's failure domain are
        preferred — same-domain peers are only used when no other
        domain is usable at all. Replicas then spread across distinct
        failure domains round-robin (one per domain before a second in
        any), healthiest-first within each domain, so K replicas land
        in K distinct domains whenever that many are usable."""
        now = time.monotonic() if now is None else now
        usable = [p for p in self.peers if p.health.usable(now)]
        if self.failure_domain:
            off_domain = [p for p in usable
                          if p.cfg.failure_domain != self.failure_domain]
            if off_domain:
                usable = off_domain
        # healthiest first: healthy before probation, fewer consecutive
        # failures, more lifetime successes, stable name tiebreak
        def rank(p: _Peer):
            return (0 if p.health.state(now) == "healthy" else 1,
                    p.health.consecutive_failures,
                    -p.health.successes, p.name)
        by_domain: Dict[str, List[_Peer]] = {}
        for p in sorted(usable, key=rank):
            by_domain.setdefault(p.domain, []).append(p)
        domains = sorted(by_domain,
                         key=lambda d: rank(by_domain[d][0]))
        chosen: List[_Peer] = []
        tier = 0
        while len(chosen) < self.replication_factor:
            progressed = False
            for d in domains:
                if len(chosen) >= self.replication_factor:
                    break
                if tier < len(by_domain[d]):
                    chosen.append(by_domain[d][tier])
                    progressed = True
            if not progressed:
                break
            tier += 1
        return chosen

    # -------------------------------------------------------- replicate
    def _chain_entries(self, step: int, directory: str,
                       marker: dict) -> List[dict]:
        """The generation chain to ship, oldest-first: for each link a
        dict of {step, marker, gen, prefix, files}. The enqueued step's
        marker is authoritative (passed in); ancestors are read from
        their local directories — retention pins them while any delta
        references them, so they must be present."""
        root = os.path.dirname(os.path.abspath(directory))
        entries = []
        for s in layout.chain_steps(root, step):
            if s == step:
                m, d = marker, directory
            else:
                d = os.path.join(root, layout.step_dir_name(s))
                m = layout.verify_commit(d, deep=False)
            entries.append({
                "step": s, "marker": m,
                "gen": remote_generation(m),
                "files": layout.commit_files(d, m, self.volume_roots,
                                             digests=True),
            })
        return entries

    def _object_ok(self, store: ObjectStore, key: str, size: int,
                   crc: Optional[int]) -> bool:
        """Is the peer's existing copy of one object reusable? Size
        must match; when the local COMMIT recorded a CRC and
        ``verify_skips`` is on, the peer bytes are read back and
        CRC-checked — a retry must never 'skip' over a torn object a
        killed earlier attempt left at the right size."""
        if store.size(key) != size:
            return False
        if crc is None or not self.verify_skips:
            return True
        try:
            return (zlib.crc32(store.get(key)) & 0xFFFFFFFF) == crc
        except Exception:
            return False

    def _ship_chain_to_peer(self, peer: _Peer, entries: List[dict],
                            stats: ReplicationStats
                            ) -> PeerReplicaResult:
        """Replicate the whole chain to ONE peer, oldest link first —
        a peer-visible delta COMMIT therefore always lands after its
        base's, so any committed delta on a peer is replayable from
        that same peer. Per-generation protocol is the remote tier's:
        payload objects (skip-if-already-ok), then COMMIT strictly
        last."""
        res = PeerReplicaResult(peer=peer.name)
        rst = retry.RetryStats()
        try:
            for e in entries:
                prefix = remote_prefix(e["step"], e["gen"])
                commit_key = f"{prefix}/{REMOTE_COMMIT}"
                if self._op(peer, lambda: peer.store.exists(commit_key)):
                    res.n_skipped += len(e["files"])
                    continue
                # content-addressed keys (DESIGN.md §12): a delta
                # chain's keyframe ships ONCE per peer no matter how
                # many later links re-enqueue it, and unchanged shards
                # across steps dedupe exactly as on the remote tier
                for f in e["files"]:
                    key = cas_key(entry_digest(f))
                    if self._object_ok(peer.store, key, f["size"],
                                       f.get("crc32")):
                        res.n_skipped += 1
                        continue
                    retry.call_with_retry(
                        lambda k=key, p=f["path"]:
                            peer.store.put_file(k, p),
                        self.retry_policy, stats=rst)
                    res.n_uploaded += 1
                    res.bytes_sent += f["size"]
                peer_marker = dict(e["marker"])
                peer_marker["remote_generation"] = e["gen"]
                peer_marker["objects"] = {f["name"]: f["size"]
                                          for f in e["files"]}
                peer_marker["object_crc32"] = {
                    f["name"]: f["crc32"]
                    for f in e["files"] if "crc32" in f}
                peer_marker["object_digest"] = {
                    f["name"]: entry_digest(f) for f in e["files"]}
                peer_marker["uploaded_at"] = time.time()
                peer_marker["replicated_by"] = self.failure_domain or ""
                blob = json.dumps(peer_marker, sort_keys=True).encode()
                retry.call_with_retry(
                    lambda k=commit_key, b=blob: peer.store.put(k, b),
                    self.retry_policy, stats=rst)
            res.ok = True
        except BaseException as e:      # noqa: BLE001 — recorded, not lost
            res.error = f"{type(e).__name__}: {e}"
        finally:
            with self._lock:
                stats.retries += rst.retries
                stats.attempts += rst.attempts
                stats.backoff_seconds += rst.backoff_seconds
        return res

    def _op(self, peer: _Peer, fn):
        """One non-put peer operation under the per-attempt deadline
        (no retry: a flaky probe counts against the peer's health via
        the surrounding job)."""
        if self.op_timeout is not None:
            return retry.deadline_call(fn, self.op_timeout)
        return fn()

    def _replicate_one(self, step: int, directory: str,
                       marker: dict) -> ReplicationStats:
        t0 = time.perf_counter()
        entries = self._chain_entries(step, directory, marker)
        head = entries[-1]
        stats = ReplicationStats(step=step, generation=head["gen"],
                                 chain_len=len(entries),
                                 n_objects=sum(len(e["files"])
                                               for e in entries))
        targets = self.place()
        stats.target = min(self.replication_factor,
                           max(len(targets), 1))
        if not targets:
            stats.seconds = time.perf_counter() - t0
            self._note_health([], stats)
            raise ReplicationError(
                f"step {step}: no usable peer (all "
                f"{len(self.peers)} ejected) — replication failed, "
                f"step stays pinned locally")
        # all K transfers in parallel; each peer op is deadline-bounded
        # so this join is too (never a wedged worker)
        if len(targets) == 1:
            results = [self._ship_chain_to_peer(targets[0], entries,
                                                stats)]
        else:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(len(targets),
                                    thread_name_prefix="peer-ship") as ex:
                results = list(ex.map(
                    lambda p: self._ship_chain_to_peer(p, entries, stats),
                    targets))
        stats.per_peer = results
        stats.replicas = sum(1 for r in results if r.ok)
        stats.bytes_sent = sum(r.bytes_sent for r in results)
        stats.committed = stats.replicas >= 1
        # under-replication is judged against the CONFIGURED factor,
        # not the (possibly already degraded) placement size — a save
        # that lands on 2 of 3 configured replicas is under-replicated
        # even when only 2 peers were usable to begin with
        stats.target = self.replication_factor
        stats.under_replicated = stats.replicas < stats.target
        stats.seconds = time.perf_counter() - t0
        self._note_health(results, stats)
        self._fold(stats)
        if not stats.committed:
            raise ReplicationError(
                f"step {step}: replication failed on every targeted "
                f"peer ({', '.join(f'{r.peer}: {r.error}' for r in results)})"
                f" — step stays pinned locally")
        return stats

    def _note_health(self, results: List[PeerReplicaResult],
                     stats: ReplicationStats):
        by_name = {p.name: p for p in self.peers}
        with self._lock:
            for r in results:
                p = by_name[r.peer]
                was_ejected = p.health.ejected_at is not None
                if r.ok:
                    p.health.record_success()
                else:
                    p.health.record_failure(r.error)
                    if p.health.ejected_at is not None \
                            and not was_ejected:
                        self.totals.ejections += 1
            level = (stats.replicas, stats.target)
        # a ZERO-replica job is a failure (ReplicationError), not a
        # degradation — only warn for committed-but-short landings
        if 0 < stats.replicas < stats.target \
                and level != self._warned_level:
            self._warned_level = level
            warnings.warn(
                f"checkpoint step {stats.step} is UNDER-REPLICATED: "
                f"{stats.replicas}/{stats.target} peer replicas "
                f"(training continues; the step stays pinned locally "
                f"until fully replicated)", stacklevel=2)
        elif stats.replicas >= stats.target:
            self._warned_level = None

    def _fold(self, s: ReplicationStats):
        with self._lock:
            t = self.totals
            if s.committed:
                t.replications += 1
            if s.under_replicated:
                t.under_replicated_saves += 1
            t.bytes_sent += s.bytes_sent
            t.retries += s.retries
            t.backoff_seconds += s.backoff_seconds
            t.seconds += s.seconds

    # ------------------------------------------------------------ query
    def unreplicated_steps(self) -> List[int]:
        """Steps not yet durable at the FULL replication target —
        queued, in flight, failed, or under-replicated. The retention
        pin set: local GC must not delete these (DESIGN.md §11 pin
        rule)."""
        with self._lock:
            return sorted({*self._pending, *self._failed, *self._under})

    def pending(self) -> int:
        with self._lock:
            return sum(self._pending.values())

    def peer_status(self) -> List[dict]:
        """Observability snapshot of every peer's health."""
        now = time.monotonic()
        out = []
        with self._lock:
            for p in self.peers:
                out.append({
                    "name": p.name,
                    "failure_domain": p.cfg.failure_domain,
                    "state": p.health.state(now),
                    "consecutive_failures":
                        p.health.consecutive_failures,
                    "successes": p.health.successes,
                    "failures": p.health.failures,
                    "last_error": p.health.last_error,
                })
        return out

    # ------------------------------------------------------------ drain
    def drain(self) -> List[ReplicationStats]:
        """Block until every enqueued job finished; re-raises the FIRST
        failure (after waiting for all). Returns the successful
        tickets' results."""
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

    # --------------------------------------------------------- peer GC
    def prune_peers(self, keep_last: int) -> List[int]:
        """Peer retention: run the shared COMMIT-first chain-pinning
        sweep (:func:`repro_torch.core.upload.prune_store`) on EVERY peer.
        Steps still pinned locally (queued/failed/under-replicated) are
        never pruned. A peer that dies mid-prune is recorded against
        its health and skipped — one dead peer must never wedge the
        retention worker or abort the sweep on the survivors. Returns
        the union of pruned steps."""
        pinned = self.unreplicated_steps()
        victims: set = set()
        for p in self.peers:
            if not p.health.usable():
                continue
            try:
                pruned = self._op(
                    p, lambda s=p.store: prune_store(s, keep_last,
                                                     pinned=pinned))
            except BaseException as e:      # noqa: BLE001
                with self._lock:
                    was = p.health.ejected_at is not None
                    p.health.record_failure(
                        f"prune: {type(e).__name__}: {e}")
                    if p.health.ejected_at is not None and not was:
                        self.totals.ejections += 1
                continue
            else:
                victims.update(pruned)
        return sorted(victims)

    # ---------------------------------------------------------- restore
    def ordered_restore_peers(self) -> List[Tuple[str, ObjectStore]]:
        """(name, store) of every peer, healthiest first — ejected
        peers LAST rather than skipped: on the restore path a copy on
        a flaky peer beats no copy at all."""
        now = time.monotonic()

        def rank(p: _Peer):
            return ({"healthy": 0, "probation": 1,
                     "ejected": 2}[p.health.state(now)],
                    p.health.consecutive_failures,
                    -p.health.successes, p.name)
        return [(p.name, p.store)
                for p in sorted(self.peers, key=rank)]

    def hydrate(self, primary_root: str, step: Optional[int] = None,
                io_config=None, verify: bool = True, readers: int = 1,
                cache=None, stats=None) -> int:
        """Restore-from-peer (``engine.load(tier="peer")`` lands
        here): hydrate the newest fully-replicated chain from the
        healthiest peer holding it. See :func:`hydrate_from_peers`."""
        hydrated, peer_name = hydrate_from_peers(
            self.ordered_restore_peers(), primary_root, step=step,
            io_config=io_config, verify=verify, readers=readers,
            cache=cache, stats=stats)
        return hydrated


# =================================================== chain completeness
def chain_complete(store: ObjectStore, step: int, generation: str,
                   max_hops: int = 10000) -> bool:
    """True when the committed generation ``(step, generation)`` on
    ``store`` has its WHOLE restore chain committed there too: every
    ``delta`` link's base — matched by the SAVE nonce the delta pinned
    (``base_gen``), never by recency — down to the keyframe. A peer
    holding a delta whose base was never (or no longer is) committed
    on it cannot serve a restore."""
    hops = 0
    while True:
        try:
            commit = read_remote_commit(store, step, generation)
        except Exception:
            return False
        dinfo = commit.get("delta")
        if not isinstance(dinfo, dict) or "base_step" not in dinfo:
            return True
        hops += 1
        if hops > max_hops:
            return False
        base_step = int(dinfo["base_step"])
        base_gen = str(dinfo.get("base_gen", ""))
        found = None
        for s, g in remote_generations(store, base_step):
            try:
                c = read_remote_commit(store, s, g)
            except Exception:
                continue
            if str(c.get("generation", "")) == base_gen:
                found = g
        if found is None:
            return False
        step, generation = base_step, found


def fully_replicated_steps(store: ObjectStore) -> List[int]:
    """Sorted steps with at least one committed generation whose whole
    chain is committed on ``store`` — the steps this single peer can
    serve a restore of."""
    out = set()
    for s, g in remote_generations(store):
        if s in out:
            continue
        if chain_complete(store, s, g):
            out.add(s)
    return sorted(out)


def hydrate_from_peers(peers: Sequence[Tuple[str, ObjectStore]],
                       primary_root: str, step: Optional[int] = None,
                       io_config=None, verify: bool = True,
                       readers: int = 1, cache=None, stats=None
                       ) -> Tuple[int, str]:
    """Rebuild a local checkpoint from the peer tier.

    Scans ``peers`` (an ordered (name, store) sequence — healthiest
    first when the caller tracks health) for committed generations
    with COMPLETE chains, picks the newest such step across all
    reachable peers — ties broken toward the earlier (healthier) peer
    — and hydrates it through :func:`repro_torch.core.upload.hydrate`
    (staging → CRC verification via ``reader.read_stream`` → local
    COMMIT → atomic publish; the delta chain is walked by ``base_gen``
    exactly as on the remote tier). Unreachable peers are skipped.

    Args:
        peers: ordered (name, store) pairs.
        primary_root: the engine's primary checkpoint directory.
        step: specific step; newest fully-replicated when None.
        io_config / verify / readers / cache / stats: as in
            :func:`repro_torch.core.upload.hydrate` (parallel ranged
            hydration and the serving read cache work against a peer's
            store exactly as against the remote tier).

    Returns:
        ``(hydrated step, serving peer's name)``.

    Raises:
        FileNotFoundError: no reachable peer holds a complete chain
            (for ``step``, when given) — callers fall back to the
            remote tier, then raise.
    """
    candidates = []          # (step, peer order index, name, store)
    for idx, (name, store) in enumerate(peers):
        try:
            steps = fully_replicated_steps(store)
        except Exception:
            continue                      # unreachable peer: skip
        if step is not None:
            if step in steps:
                candidates.append((step, idx, name, store))
        elif steps:
            candidates.append((steps[-1], idx, name, store))
    if not candidates:
        raise FileNotFoundError(
            f"no peer holds a fully-replicated checkpoint chain"
            f"{f' for step {step}' if step is not None else ''} "
            f"(peers scanned: {len(list(peers))})")
    best_step = max(c[0] for c in candidates)
    _, _, name, store = min(
        (c for c in candidates if c[0] == best_step),
        key=lambda c: c[1])
    hydrated = hydrate(store, primary_root, step=best_step,
                       io_config=io_config, verify=verify,
                       readers=readers, cache=cache, stats=stats)
    return hydrated, name
