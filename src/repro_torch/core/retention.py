"""Checkpoint retention policy + garbage collection (DESIGN.md §8 for
the tiered interaction).

Per-iteration checkpointing (the paper's headline capability) writes one
checkpoint per step — untenable to KEEP them all (S_C × steps). The
production policy: retain a rolling window of the most recent k, plus
every Nth as a permanent milestone; deletion runs on the helper thread so
it never blocks training (same decoupling argument as §4.3).

Crash safety: a checkpoint directory is only eligible for deletion if a
NEWER one is fully committed (manifest present), so an interruption
mid-GC always leaves a loadable checkpoint.

Tiered durability (the pin rule, DESIGN.md §8/§11): with further tiers
behind the local NVMe, local retention may keep FEWER steps than they
do — but a step that is *not yet durable at the configured tier* is
PINNED against local GC: for the object tier that means its upload has
not reached the remote COMMIT (queued, in flight, or failed); for the
peer tier that its replication has not reached the FULL replication
target (queued, in flight, failed, or under-replicated). Local GC must
never delete what may be the only — or the only fully-replicated —
copy. ``remote_keep_last`` / ``peer_keep_last`` independently bound
those tiers (0 = keep everything there).

Delta chains (DESIGN.md §9): an incremental delta generation is only
restorable while its base — transitively, its keyframe — exists. The
keep set is therefore expanded with every chain ancestor of a kept
step before victims are chosen, so retention never deletes a keyframe
(or intermediate delta) that a live delta still references. Chain
walking goes through ``layout.delta_base`` and deletion through the
COMMIT's shard list, so striped delta generations (DESIGN.md §13 —
payload carved across volumes) pin and collect exactly like
single-stream ones.

Content-addressed payloads (DESIGN.md §12): on the remote/peer tiers a
pruned generation deletes only its COMMIT and metadata eagerly — the
``cas/<digest>`` payload objects it references are REFCOUNTED by the
surviving COMMITs, and :func:`repro_torch.core.upload.collect_cas_orphans`
sweeps exactly the unreferenced ones afterwards (on the tier's worker
thread, where uploads serialize). A shard digest shared with a kept
generation therefore outlives any one prune, so dedup never makes
retention lossy.

A copy of ``repro.core.retention``: the same step sets, the same
pinning rules.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence

from repro_torch import spans
from repro_torch.core import layout


@dataclass(frozen=True)
class RetentionPolicy:
    keep_last: int = 2            # rolling window of most recent ckpts
    keep_every: int = 0           # every Nth step is permanent (0 = none)
    #: remote-tier retention (tiered backends): keep this many
    #: most-recent STEPS in the object store, 0 = keep every uploaded
    #: generation. Typically >= keep_last — short local NVMe window,
    #: long remote history.
    remote_keep_last: int = 0
    #: peer-tier retention (DESIGN.md §11): keep this many most-recent
    #: STEPS on every peer, 0 = keep every replicated generation. Peer
    #: RAM/NVMe is the scarcest tier, so typically keep_last <=
    #: peer_keep_last <= remote_keep_last.
    peer_keep_last: int = 0


def _committed_steps(directory: str) -> List[int]:
    # COMMIT-marked (engine) and legacy (manifest-only) checkpoints are
    # both eligible; staging .tmp dirs and stray entries never are.
    return layout.committed_steps(directory, legacy_ok=True)


def _chain_ancestors(directory: str, steps: Iterable[int]) -> set:
    """Transitive delta-base closure: every step some step in ``steps``
    depends on for restore (delta → base → ... → keyframe)."""
    closure: set = set()
    frontier = list(steps)
    while frontier:
        s = frontier.pop()
        base = layout.delta_base(
            os.path.join(directory, layout.step_dir_name(s)))
        if base is None:
            continue
        bstep = base[0]
        if bstep not in closure:
            closure.add(bstep)
            frontier.append(bstep)
    return closure


def collectable(directory: str, policy: RetentionPolicy,
                pinned: Iterable[int] = ()) -> List[int]:
    """Steps whose checkpoints may be deleted under ``policy``.

    ``pinned`` steps are never collectable regardless of the policy —
    the upload tier pins every step whose remote COMMIT has not landed
    (deleting it locally could destroy the only durable copy). Delta
    chains pin transitively: every chain ancestor (base deltas and the
    keyframe) of a kept step is itself kept, so a surviving delta can
    always be replayed."""
    steps = _committed_steps(directory)
    if not steps:
        return []
    keep = set(steps[-max(policy.keep_last, 1):])
    if policy.keep_every:
        keep |= {s for s in steps if s % policy.keep_every == 0}
    keep |= set(pinned)
    keep |= _chain_ancestors(directory, keep)
    return [s for s in steps if s not in keep]


def collect(directory: str, policy: RetentionPolicy,
            volume_roots: Optional[Sequence[str]] = None,
            pinned: Iterable[int] = ()) -> List[int]:
    """Delete collectable checkpoints — a step is removed across ALL
    volumes its COMMIT references (primary dir first, so the step is
    un-committed atomically; a crash mid-delete strands only
    unreferenced shard dirs, which the engine's startup sweep removes).
    ``pinned`` steps are skipped (see :func:`collectable`). Returns the
    deleted steps."""
    victims = collectable(directory, policy, pinned=pinned)
    # newest-first: a crash mid-sweep must never leave a delta whose
    # (older) base was already deleted — deleting the newest victim
    # first keeps every surviving chain replayable at all times
    with spans.span("retention.delete"):
        for s in sorted(victims, reverse=True):
            layout.delete_step(directory, s, volume_roots)
    return sorted(victims)


class RetentionManager:
    """Runs GC off the critical path after each commit.

    With ``upload`` (an :class:`repro_torch.core.upload.UploadManager`) and/or
    ``peers`` (a :class:`repro_torch.core.peer.PeerReplicator`), the manager
    enforces the tiered pin rule — local GC skips every step not yet
    durable at the configured tier: queued/failed uploads AND
    queued/failed/under-replicated replications. ``policy.
    remote_keep_last`` / ``policy.peer_keep_last`` prune old remote /
    peer generations after each local sweep."""

    def __init__(self, directory: str, policy: RetentionPolicy,
                 volume_roots: Optional[Sequence[str]] = None,
                 upload=None, peers=None):
        self.directory = directory
        self.policy = policy
        self.volume_roots = volume_roots
        self.upload = upload
        self.peers = peers
        self._lock = threading.Lock()
        self.deleted: List[int] = []
        self.remote_deleted: List[int] = []
        self.peer_deleted: List[int] = []

    def _pinned(self) -> set:
        pinned = set()
        if self.upload is not None:
            pinned.update(self.upload.unuploaded_steps())
        if self.peers is not None:
            pinned.update(self.peers.unreplicated_steps())
        return pinned

    def after_commit(self):
        """Call after a checkpoint commits (e.g. from the engine's helper
        thread or the trainer loop). Thread-safe, idempotent. Remote and peer
        pruning are only ENQUEUED here — each runs on its own tier's
        worker thread, so the caller (the training loop) never blocks on
        WAN/peer lists-and-deletes; a dead peer is the replicator's
        problem, never the trainer's."""
        with self._lock:
            self.deleted += collect(self.directory, self.policy,
                                    self.volume_roots,
                                    pinned=self._pinned())
            if self.upload is not None and self.policy.remote_keep_last:
                self.upload.enqueue_prune(self.policy.remote_keep_last,
                                          on_done=self.remote_deleted.extend)
            if self.peers is not None and self.policy.peer_keep_last:
                self.peers.enqueue_prune(self.policy.peer_keep_last,
                                         on_done=self.peer_deleted.extend)
