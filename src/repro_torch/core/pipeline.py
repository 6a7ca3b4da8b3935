"""Pipelined checkpointing (paper §4.3).

A dedicated helper worker persists checkpoint i while the main thread
runs forward/backward of iteration i+1; the main thread blocks only
before the NEXT optimizer step until the previous checkpoint commits
(Fig. 4d). Protocol (verbatim from §4.3):

  helper:  loop { block until woken; write tensors; signal completion }
  main:    before optimizer: wait for previous commit
           after  optimizer: send new checkpoint request

DEPRECATED as a public API: prefer ``repro_torch.core.engine.CheckpointEngine``
with backend ``"fastpersist-pipelined"``, whose ``SaveHandle`` futures and
crash-atomic commits subsume this wrapper (DESIGN.md §4 has the migration
table). The class remains as a standalone utility for wrapping arbitrary
checkpointers.

In-place note (ROADMAP.md C.6): the port's optimizer updates the state's
tensors IN PLACE, so a snapshot taken after the next update would hold
the next step's values. :meth:`PipelinedCheckpointer.submit` therefore
returns only once the save's device→host snapshot has landed — the
trainer's sync (``engine.wait_snapshot()`` before the next update) moved
into ``submit`` — and the caller may update the state as soon as it
returns, while the write keeps overlapping. Inner checkpointers without
snapshot signalling complete the whole save first.

Arena note (DESIGN.md §6): an inner checkpointer that owns a
``SerializeArena`` reuses it across OVERLAPPED saves safely, because
this wrapper's single helper thread executes queued saves strictly in
order — save *i+1*'s serialize (which refills the arena in place) can
only start after save *i* finished reading it. ``PipelineStats`` counts
the steady-state reuses.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, List, Optional


@dataclass
class PipelineStats:
    submitted: int = 0
    committed: int = 0
    stall_seconds: float = 0.0       # main-thread time blocked in wait()
    #                                  or wait_snapshot()
    snapshot_stall_seconds: float = 0.0  # the wait_snapshot() share
    write_seconds: float = 0.0       # helper time actually persisting
    arena_reuses: int = 0            # overlapped saves that refilled the
    #                                  inner checkpointer's arena in place
    save_stats: List[Any] = field(default_factory=list)


class PipelinedCheckpointer:
    """Wraps any checkpointer with a save(state, step, extras=None) method."""

    def __init__(self, inner, max_outstanding: int = 1):
        self.inner = inner
        self._q = queue.Queue()
        self._outstanding = 0
        self._snap_outstanding = 0   # jobs whose snapshot hasn't landed
        self._lock = threading.Condition()
        self._err: Optional[BaseException] = None
        self.stats = PipelineStats()
        self._stop = False
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()
        self.max_outstanding = max_outstanding

    # ----------------------------------------------------------- helper
    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            state, step, extras = item
            t0 = time.perf_counter()
            snap_fired = threading.Event()

            def _on_snapshot():
                # one decrement per job, whether the inner checkpointer
                # signals (chunked snapshot landed) or never does
                # (no on_snapshot support / failed save — the finally
                # below settles it)
                if not snap_fired.is_set():
                    snap_fired.set()
                    with self._lock:
                        self._snap_outstanding -= 1
                        self._lock.notify_all()

            if hasattr(self.inner, "on_snapshot"):
                self.inner.on_snapshot = _on_snapshot
            try:
                s = self.inner.save(state, step, extras) \
                    if extras is not None else self.inner.save(state, step)
                self.stats.save_stats.append(s)
                if getattr(s, "arena_reused", False):
                    self.stats.arena_reuses += 1
            except BaseException as e:       # surfaced on next wait()
                self._err = e
            finally:
                _on_snapshot()
            self.stats.write_seconds += time.perf_counter() - t0
            with self._lock:
                self._outstanding -= 1
                self.stats.committed += 1
                self._lock.notify_all()

    # ------------------------------------------------------ main thread
    def wait(self):
        """Block until every submitted checkpoint is committed to disk.
        Called BEFORE the optimizer step (the §4.3 sync point)."""
        t0 = time.perf_counter()
        with self._lock:
            while self._outstanding > 0:
                self._lock.wait()
        self.stats.stall_seconds += time.perf_counter() - t0
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def wait_snapshot(self):
        """Block only until every submitted save's device→staging
        snapshot has landed (DESIGN.md §10) — the chunk-granular half of
        the §4.3 sync point. The writes keep overlapping the caller's
        next iteration; ``wait()``/``close()`` remain the durability
        points. Degrades to :meth:`wait` for inner checkpointers without
        snapshot signalling. Re-raises an already-surfaced failure."""
        t0 = time.perf_counter()
        with self._lock:
            while self._snap_outstanding > 0:
                self._lock.wait()
        dt = time.perf_counter() - t0
        self.stats.stall_seconds += dt
        self.stats.snapshot_stall_seconds += dt
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def submit(self, state, step: int, extras: Optional[dict] = None):
        """Enqueue checkpoint creation. Called AFTER the optimizer step;
        returns once the save's snapshot has landed, so the caller may
        update ``state`` in place from then on (see the module note).
        Re-raises a failure surfaced by then."""
        with self._lock:
            while self._outstanding >= self.max_outstanding:
                self._lock.wait()
            self._outstanding += 1
            self._snap_outstanding += 1
        self.stats.submitted += 1
        self._q.put((state, step, extras))
        self.wait_snapshot()

    def close(self):
        self.wait()
        self._q.put(None)
        self._t.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
