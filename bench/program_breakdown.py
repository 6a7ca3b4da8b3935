"""The program's own breakdown of a cell: one traced run of the cell, as
``bench/run.py --trace 1`` makes it, with the program's spans
(``repro_torch.spans``) recorded from before the trainer is built:

    python3 bench/program_breakdown.py --workload CELL --seed N --seconds S

It prints the run's checks on standard error and one JSON object as the
last line of standard output (:func:`readings`). It needs the card, as
the benchmark does, and changes nothing of the cell or its runs.

A span is ``(name, thread, t0, t1, nbytes)`` on the host's
``perf_counter`` clock, the clock :mod:`bench.trace` puts the device
trace on. :func:`idle_program` splits each idle gap of the traced
stretch at the spans' edges and gives each piece two labels:

* the innermost span of the training thread open over it (of two open
  spans, the later started), or the innermost harness span where the
  program has none open, else ``"untraced"``;
* while that span is ``data.*`` or ``train.*``: the save threads' spans
  (``snapshot.*``, ``write.*``, ``commit.*``) open over it, their
  distinct names joined by ``+``, else ``"none"``.

The gaps themselves are :func:`bench.trace.reduce`'s: the same device
events, clipped to the same stretch."""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import tempfile  # noqa: E402
from collections import defaultdict  # noqa: E402

from bench import common, run, trace  # noqa: E402

#: spans of the save threads that may slow the training thread
SAVE_SPANS = ("snapshot.", "write.", "commit.")
#: the training thread's spans under which a save thread's work counts
#: as overlap
STEP_SPANS = ("data.", "train.")


def idle_gaps(dev, w0: float, w1: float) -> list:
    """[(start, end)] host seconds in [w0, w1] with no device event, as
    :func:`bench.trace.reduce` finds them; [] when the marker is
    missing."""
    marks = sorted(s for s, _, n in dev if trace.MARKER in n)
    if not marks or w0 is None or w1 is None:
        return []
    off = marks[0] / 1e9 - w0
    clip = [(max(s / 1e9 - off, w0), min(e / 1e9 - off, w1))
            for s, e, n in dev if trace.MARKER not in n]
    busy = trace._union([c for c in clip if c[1] > c[0]])
    gaps, cur = [], w0
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if cur < w1:
        gaps.append((cur, w1))
    return gaps


def _innermost(open_spans):
    """The name of the latest-started span (the shortest of equals)."""
    return max(open_spans, key=lambda s: (s[2], s[2] - s[3]))[1]


def idle_program(dev, harness, program, w0: float, w1: float,
                 main: str = "MainThread", top: int = 10) -> dict:
    """``harness``: [(name, t0, t1)]; ``program``: the program's spans.
    Returns ``idle_gaps_program`` and ``idle_under_save`` as
    [[label, seconds]] (most first, ``top`` of each), and
    ``persist_idle_s``: idle seconds in which the training thread is in
    ``data.*`` or ``train.*`` and a save thread is in ``write.*`` or
    ``commit.*``. {} when the marker is missing."""
    gaps = idle_gaps(dev, w0, w1)
    if not gaps:
        return {}
    tagged = [("main" if th == main else "save", n, a, b)
              for n, th, a, b, _ in program
              if th == main or n.startswith(SAVE_SPANS)]
    tagged += [("outer", n, a, b) for n, a, b in harness]
    tagged = [s for s in tagged if s[3] > w0 and s[2] < w1]
    by_main, by_save = defaultdict(float), defaultdict(float)
    persist = 0.0
    for g0, g1 in gaps:
        near = [s for s in tagged if s[2] < g1 and s[3] > g0]
        cuts = sorted({g0, g1, *(t for s in near for t in s[2:]
                                 if g0 < t < g1)})
        for a, b in zip(cuts, cuts[1:]):
            m = (a + b) / 2
            here = [s for s in near if s[2] <= m < s[3]]
            in_main = [s for s in here if s[0] == "main"]
            in_outer = [s for s in here if s[0] == "outer"]
            label = (_innermost(in_main) if in_main else
                     _innermost(in_outer) if in_outer else "untraced")
            by_main[label] += b - a
            if not in_main or not label.startswith(STEP_SPANS):
                continue
            names = sorted({s[1] for s in here if s[0] == "save"})
            by_save["+".join(names) or "none"] += b - a
            if any(n.startswith(("write.", "commit.")) for n in names):
                persist += b - a

    def ranked(d):
        return sorted(([n, t] for n, t in d.items()),
                      key=lambda x: -x[1])[:top]
    return {"idle_gaps_program": ranked(by_main),
            "idle_under_save": ranked(by_save),
            "persist_idle_s": persist}


def _total(prog, name: str, after=None, before=None) -> tuple:
    """(seconds, count) of the spans called ``name`` that start in
    [after, before)."""
    ts = [b - a for n, _, a, b, _ in prog if n == name
          and (after is None or a >= after)
          and (before is None or a < before)]
    return sum(ts), len(ts)


def readings(prog: list, out: dict, seen: dict) -> dict:
    """What the program's spans ``prog`` say of a run of the training
    traffic (``out``, the generator's result; ``seen``, the traced
    stretch's device events, harness spans and edges, empty when the run
    was not traced):

    * ``data_draw_ms``: mean ``data.draw`` of the window's steps;
    * ``arena_alloc_s``: the set-up's ``snapshot.alloc`` (the arena's
      first pinned allocation);
    * ``save_overhead_s``: per window save, ``save.prepare`` +
      ``save.manifest`` + ``retention.delete``;
    * ``commit``: per window save, each ``commit.*`` span and the
      ``commit_phase_s`` the stats give;
    * with a trace, the harness's reduction of the stretch
      (``window_s``, ``busy_s``, ``idle_gaps``), :func:`idle_program`'s
      three readings and ``device_idle_share.persist``,
      ``persist_idle_s`` as a share of the stretch."""
    w = out["setup_end"]
    saves = out["records"]["saves"]
    n = max(len(saves), 1)
    draw, steps = _total(prog, "data.draw", after=w)
    r = {"correct": all(c["ok"] for c in out["checks"]),
         "window_saves": len(saves),
         "data_draw_ms": 1e3 * draw / steps if steps else None,
         "data_h2d_ms": (1e3 * _total(prog, "data.h2d", after=w)[0] / steps
                         if steps else None),
         "arena_alloc_s": _total(prog, "snapshot.alloc", before=w)[0],
         "save_overhead_s": sum(_total(prog, k, after=w)[0] for k in (
             "save.prepare", "save.manifest", "retention.delete")) / n,
         "commit": dict(
             {k: _total(prog, k, after=w)[0] / n for k in (
                 "commit.fsync", "commit.marker", "commit.publish")},
             commit_phase_s=sum(s["commit_seconds"] for s in saves) / n)}
    if seen:
        tr = out["records"].get("trace") or {}
        r.update({k: tr[k] for k in ("window_s", "busy_s", "idle_gaps")
                  if k in tr})
        idle = idle_program(seen["dev"], seen["harness"], prog,
                            seen["w0"], seen["w1"])
        r.update(idle)
        if idle:
            r["device_idle_share.persist"] = 100.0 * idle[
                "persist_idle_s"] / (seen["w1"] - seen["w0"])
    return r


def collect(ctx, generator: str = "train_ckpt") -> tuple:
    """Runs the generator on ``ctx`` with the program's spans recorded.
    Returns its result, the spans, the number the recorder dropped and,
    where the run was traced, ``{"dev", "harness", "w0", "w1"}`` of its
    stretch."""
    from repro_torch import spans
    gen = run.load_by_path(os.path.join(common.BENCH, "generators",
                                        generator + ".py"),
                           "bench.generators." + generator)
    seen = {}
    plain = trace.Stretch.result

    def result(stretch, harness):
        seen.update(dev=trace.device_events(stretch._prof),
                    harness=list(harness),
                    w0=stretch.t0, w1=stretch.t1)
        return trace.reduce(seen["dev"], harness, stretch.t0, stretch.t1)

    trace.Stretch.result = result
    spans.take()
    spans.record(True)
    try:
        out = gen.run(ctx)
    finally:
        spans.record(False)
        trace.Stretch.result = plain
    dropped = spans.dropped()
    return out, spans.take(), dropped, seen


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    workload = common.load("workloads", args.workload)
    generator, params = common.cell_params(workload)
    import torch
    if not torch.cuda.is_available():
        print("refused: the breakdown traces the card, and there is none",
              file=sys.stderr)
        return 2
    base = os.environ.get("TMPDIR") or os.path.join(ROOT, ".bench_tmp")
    os.makedirs(base, exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="bench-ckpt-", dir=base)
    try:
        ctx = common.Ctx(config=common.load("configs", workload["config"]),
                         params=params, seed=args.seed, seconds=args.seconds,
                         trace=True, device="cuda:0", ckpt_dir=ckpt)
        out, prog, dropped, seen = collect(ctx, generator)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    for c in out["checks"]:
        print(f"check {c['name']} {c['value']} limit {c['limit']} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    r = dict(readings(prog, out, seen), workload=args.workload,
             seed=args.seed, spans=len(prog), dropped=dropped,
             device=torch.cuda.get_device_name(0))
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
