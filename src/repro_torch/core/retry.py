"""Shared retry discipline: exponential backoff + full jitter +
per-attempt deadlines (DESIGN.md §8/§11).

Both wide-area tiers — the object-store :class:`~repro_torch.core.upload.
UploadManager` and the peer-replication :class:`~repro_torch.core.peer.
PeerReplicator` — talk to stores that fail transiently (throttling,
flaky links, restarting peers). Before this module each had its own
ad-hoc loop; now both share ONE policy object and ONE driver:

    policy = RetryPolicy(max_retries=3, base_backoff=0.05)
    stats  = RetryStats()
    call_with_retry(lambda: store.put_file(key, path), policy, stats)

Backoff follows "exponential backoff and full jitter" (the AWS
architecture-blog formulation): attempt ``n`` sleeps a uniform random
draw from ``[0, min(max_backoff, base_backoff * 2**n)]``. Full jitter
(rather than equal or no jitter) decorrelates a fleet of writers
retrying against the same overloaded store — exactly the
checkpoint-storm scenario per-iteration checkpointing creates.

Per-attempt deadlines: a peer that HANGS is worse than a peer that
fails fast — without a bound, one wedged TCP connection stalls the
whole replication worker. :func:`deadline_call` runs one operation on
a daemon thread and abandons it past the deadline (`DeadlineExceeded`,
a ``TimeoutError``); ``RetryPolicy.attempt_timeout`` makes
:func:`call_with_retry` wrap every attempt that way. The abandoned
thread may linger until its syscall returns — the store-object
contract (atomic dot-tmp puts) keeps a late completion harmless.

A copy of ``repro.core.retry`` (pure Python).
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple, Type


class DeadlineExceeded(TimeoutError):
    """An operation overran its per-attempt deadline (the worker thread
    was abandoned; a late completion is harmless by the atomic-put
    store contract)."""


@dataclass(frozen=True)
class RetryPolicy:
    """How a transient-failure-prone operation is retried.

    Attributes:
        max_retries: retry budget; total attempts = ``max_retries + 1``.
        base_backoff: backoff cap before attempt 1 (seconds); doubles
            every further attempt.
        max_backoff: upper bound of any single sleep (seconds).
        attempt_timeout: per-attempt wall-clock deadline (seconds);
            None = no deadline (the operation may block forever).
        retry_on: exception classes that consume retry budget; anything
            else propagates immediately (a programming error should
            never be retried into the ground).
    """
    max_retries: int = 2
    base_backoff: float = 0.05
    max_backoff: float = 2.0
    attempt_timeout: Optional[float] = None
    retry_on: Tuple[Type[BaseException], ...] = (Exception,)

    def backoff(self, attempt: int, rng: Optional[random.Random] = None
                ) -> float:
        """Full-jitter sleep before retry number ``attempt`` (1-based):
        uniform in ``[0, min(max_backoff, base_backoff * 2**(a-1))]``."""
        cap = min(self.max_backoff,
                  self.base_backoff * (2.0 ** max(attempt - 1, 0)))
        draw = (rng.random() if rng is not None else random.random())
        return cap * draw


@dataclass
class RetryStats:
    """Mutable per-call (or folded per-tier) retry accounting."""
    attempts: int = 0              # total attempts made (>= 1 per call)
    retries: int = 0               # attempts beyond the first
    backoff_seconds: float = 0.0   # total time slept between attempts
    deadline_hits: int = 0         # attempts killed by attempt_timeout

    def fold(self, other: "RetryStats"):
        self.attempts += other.attempts
        self.retries += other.retries
        self.backoff_seconds += other.backoff_seconds
        self.deadline_hits += other.deadline_hits


def deadline_call(fn: Callable[[], object], timeout: float):
    """Run ``fn()`` with a wall-clock deadline. Returns its result, or
    raises :class:`DeadlineExceeded` after ``timeout`` seconds — the
    worker thread is a daemon and is abandoned, never joined."""
    result: list = []
    exc: list = []
    done = threading.Event()

    def _run():
        try:
            result.append(fn())
        except BaseException as e:     # noqa: BLE001 — re-raised below
            exc.append(e)
        finally:
            done.set()

    t = threading.Thread(target=_run, daemon=True,
                         name="retry-deadline-call")
    t.start()
    if not done.wait(timeout):
        raise DeadlineExceeded(
            f"operation overran its {timeout:.3f}s deadline")
    if exc:
        raise exc[0]
    return result[0] if result else None


def call_with_retry(fn: Callable[[], object], policy: RetryPolicy,
                    stats: Optional[RetryStats] = None,
                    rng: Optional[random.Random] = None,
                    sleep: Callable[[float], None] = time.sleep):
    """Drive ``fn`` to success under ``policy``.

    Args:
        fn: zero-arg operation; its return value is passed through.
        policy: the retry discipline (budget, backoff, deadline).
        stats: attempts/backoff accounting, accumulated in place (pass
            a shared instance to fold many calls into one record).
        rng: jitter source (tests pass a seeded one for determinism).
        sleep: the between-attempt sleep (tests stub it out).

    Raises:
        the LAST attempt's exception once the budget is exhausted;
        non-``retry_on`` exceptions propagate from the first attempt.
    """
    stats = stats if stats is not None else RetryStats()
    attempt = 0
    while True:
        attempt += 1
        stats.attempts += 1
        try:
            if policy.attempt_timeout is not None:
                return deadline_call(fn, policy.attempt_timeout)
            return fn()
        except policy.retry_on as e:
            if isinstance(e, DeadlineExceeded):
                stats.deadline_hits += 1
            if attempt > policy.max_retries:
                raise
            stats.retries += 1
            pause = policy.backoff(attempt, rng)
            if pause > 0.0:
                t0 = time.perf_counter()
                sleep(pause)
                stats.backoff_seconds += time.perf_counter() - t0
