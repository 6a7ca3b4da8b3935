"""Program spans: where the time goes inside a call into the port.

A span is ``(name, thread_name, t0, t1, nbytes)``, its times read from
``time.perf_counter()`` — the clock the benchmark's own spans and its
device trace are aligned to, so the three compare without conversion.
Recording is off by default; :func:`record` turns it on for the whole
process and :func:`take` hands over (and clears) what was recorded.

Two kinds of site:

* ``with span(name, nbytes):`` — when recording is off, one check of a
  module-level flag and a shared no-op object: no clock read, no
  allocation.
* ``with timed(name, nbytes) as sp:`` — a region that also fills a
  stats field: it always reads the clock, the field takes
  ``sp.seconds``, and the span is recorded from the same two reads when
  recording is on.

``nbytes`` may be set on the object inside the ``with`` when it is known
only at the end (the no-op object ignores it).

The names, by layer:

=====================  ===================================================
``data.draw``          the token stream's counter-based draw (numpy)
``data.h2d``           its host→device copy, with bytes
``train.step``         ``train_step``'s body, host dispatch only
``train.adam``         the optimizer update inside it
``moe.route``          a dropless MoE layer's router, top k, balance loss
                       and pair counts (``layers.moe_apply_dropless``)
``moe.sync``           its host read of the held experts' pair counts
``moe.experts``        its grouped product over the held experts' pairs
``moe.shared``         its shared experts
``engine.save``        ``CheckpointEngine.save`` on the caller's thread
``engine.wait_snapshot``  the caller blocked on the snapshot
``engine.drain``       the caller blocked on every commit
``save.prepare``       the save's volume probe and staging dirs
``snapshot.alloc``     the arena's pinned allocation on a layout miss
``snapshot.fill``      the device→arena copy, with its D2H bytes
``write.copy``         one io buffer's fill from the stream, with bytes
``write.crc``          its CRC32, with bytes
``write.wait``         waiting for a buffer's write (or the last writes)
``save.manifest``      the manifest's JSON and its directory fsync
``commit.fsync``       the payloads' fsync
``commit.publish``     publishing the shard dirs and the step dir
``commit.marker``      the COMMIT marker
``retention.delete``   deleting superseded steps
=====================  ===================================================
"""
from __future__ import annotations

import threading
import time

#: spans kept between two :func:`take` calls; later ones are counted
#: as dropped
CAP = 65536

_on = False
_spans: list = []
_dropped = 0
_drop_lock = threading.Lock()


def record(on: bool):
    """Turn recording on or off for the whole process."""
    global _on
    _on = bool(on)


def take() -> list:
    """The spans recorded since the last call, oldest first; clears
    them and the drop count."""
    global _spans, _dropped
    out, _spans = _spans, []
    with _drop_lock:
        _dropped = 0
    return out


def dropped() -> int:
    """Spans not kept since the last :func:`take` (over :data:`CAP`)."""
    return _dropped


def _append(name: str, t0: float, t1: float, nbytes: int):
    global _dropped
    if len(_spans) < CAP:
        _spans.append((name, threading.current_thread().name, t0, t1,
                       nbytes))
    else:
        with _drop_lock:
            _dropped += 1


class Span:
    """A timed region; ``seconds`` is set on exit."""
    __slots__ = ("name", "nbytes", "t0", "seconds")

    def __init__(self, name: str, nbytes: int = 0):
        self.name = name
        self.nbytes = nbytes
        self.seconds = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self.seconds = t1 - self.t0
        if _on:
            _append(self.name, self.t0, t1, self.nbytes)
        return False


class _Off:
    """The shared span of a site while recording is off."""
    __slots__ = ()
    seconds = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __setattr__(self, name, value):
        pass


_OFF = _Off()


def span(name: str, nbytes: int = 0):
    """A span recorded only while recording is on."""
    if not _on:
        return _OFF
    return Span(name, nbytes)


def timed(name: str, nbytes: int = 0) -> Span:
    """A span whose ``seconds`` is always measured (for a stats field),
    recorded while recording is on."""
    return Span(name, nbytes)
