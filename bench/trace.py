"""Reduction of a device trace to what the per-layer metrics and the
breakdown read: the device's busy time over the traced stretch, the
device operations that took most time, and the device's idle gaps by the harness span the host was in.

The profiler records device activity only (no host operator events,
which would slow the host several-fold and inflate the idle share). The
stretch starts at a step boundary, with the device idle, by launching one
marker kernel (``torch.cuda._sleep``) right after reading the host clock:
the marker's start on the device puts device events on the host's
``perf_counter`` clock, to within the launch latency."""
from __future__ import annotations

import time
from collections import defaultdict

MARKER = "spin_kernel"


class Stretch:
    """A traced stretch: ``start()`` at a step boundary, ``stop()`` at a
    later one; ``result(spans)`` reduces it."""

    def __init__(self):
        import torch
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.t0 = self.t1 = None

    def start(self):
        import torch
        self.t0 = time.perf_counter()
        torch.cuda._sleep(1)

    def stop(self):
        self.t1 = time.perf_counter()
        self._prof.__exit__(None, None, None)

    def result(self, spans) -> dict:
        return reduce(device_events(self._prof), spans, self.t0, self.t1)


def device_events(prof):
    """[(start_ns, end_ns, name)] of the device's kernels and copies."""
    import torch
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        s = e.start_ns()
        out.append((s, s + e.duration_ns(), e.name()))
    return out


def _union(spans):
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(dev, spans, w0: float, w1: float, top: int = 10) -> dict:
    """``dev``: device events in ns of the profiler's clock, the first
    :data:`MARKER` launched at host time ``w0``; ``spans``: the harness's
    (name, t0, t1) in host seconds; the stretch is [w0, w1]. Seconds
    throughout; {} when the marker is missing."""
    marks = sorted(s for s, _, n in dev if MARKER in n)
    if not marks or w0 is None or w1 is None:
        return {}
    off = marks[0] / 1e9 - w0
    clip = [(max(s / 1e9 - off, w0), min(e / 1e9 - off, w1), n)
            for s, e, n in dev if MARKER not in n]
    clip = [c for c in clip if c[1] > c[0]]
    busy = _union([(s, e) for s, e, _ in clip])
    by_name = defaultdict(float)
    for s, e, n in clip:
        by_name[n] += e - s
    gaps, cur = [], w0
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if cur < w1:
        gaps.append((cur, w1))
    idle = defaultdict(float)
    for g0, g1 in gaps:
        # the span covering most of the gap; of equals, the innermost
        best, label = (0.0, 0.0), "untraced"
        for n, s, e in spans:
            key = (min(e, g1) - max(s, g0), s - e)
            if key[0] > 0 and key > best:
                best, label = key, n
        idle[label] += g1 - g0
    return {
        "window_s": w1 - w0,
        "busy_s": sum(e - s for s, e in busy),
        "device_ops": sorted(([n, t] for n, t in by_name.items()),
                             key=lambda x: -x[1])[:top],
        "idle_gaps": sorted(([n, t] for n, t in idle.items()),
                            key=lambda x: -x[1])[:top],
    }
