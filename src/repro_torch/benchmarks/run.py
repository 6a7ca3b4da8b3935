"""Benchmark harness of the port — one module per paper figure (the
counterpart of ``benchmarks/run.py``). Prints ``name,us_per_call,derived``
CSV, a ``<figure>/wall`` row after each figure, and exits 1 if any
figure fails.

    python -m repro_torch.benchmarks.run [--device cuda|cpu] [--only fig11,fig9]

``--device`` defaults to ``cuda`` and raises without a card.
``FASTPERSIST_BENCH_FULL=1`` runs the full (slower) sizes;
``FASTPERSIST_BENCH_DIR`` is the scratch directory (default
``./.bench_tmp``), removed at the end."""
from __future__ import annotations

import argparse
import importlib
import os
import sys
import time
import traceback

#: (row name, module) of every ported figure; ``roofline`` last, as in
#: the reference's run.py (it reads the dry run's JSON, not a figure's)
FIGURES = (
    ("fig2", "fig2_baseline_util"),
    ("fig7", "fig7_buffer_sweep"),
    ("fig8", "fig8_parallel_writes"),
    ("fig9", "fig9_dense_models"),
    ("fig11", "fig11_pipelining"),
    ("perf_writer", "perf_writer"),
    ("beyond_quant", "beyond_quant"),
    ("fig_delta", "fig_delta"),
    ("fig_snapshot", "fig_snapshot"),
    ("fig10_restore", "fig10_parallel_restore"),
    ("fig10", "fig10_moe"),
    ("table1", "table1_bandwidth"),
    ("fig12", "fig12_projection"),
    ("fig13", "fig13_tiered_upload"),
    ("fig_peer", "fig_peer"),
    ("fig_serve", "fig_serve"),
    ("roofline", "roofline"),
)


def run_all(quick: bool = True, device="cuda", only=None):
    """Run the figures named in ``only`` (every one when None) on
    ``device``. Returns ``(results, seconds, failed)``: each figure's
    return value and wall seconds by name, and the names that raised."""
    from repro_torch.benchmarks.common import cleanup, resolve_device
    device = resolve_device(device)
    names = [n for n, _ in FIGURES]
    unknown = sorted(set(only or ()) - set(names))
    if unknown:
        raise ValueError(f"unknown figures {unknown}; known: {names}")
    results, seconds, failed = {}, {}, []
    for name, module in FIGURES:
        if only and name not in only:
            continue
        mod = importlib.import_module(f"repro_torch.benchmarks.{module}")
        t0 = time.perf_counter()
        try:
            results[name] = mod.run(quick=quick, device=device)
        except Exception as e:
            failed.append(name)
            traceback.print_exc()
            print(f"{name}/FAILED,0.0,{e!r}", flush=True)
        seconds[name] = time.perf_counter() - t0
        print(f"{name}/wall,{seconds[name]*1e6:.1f},"
              f"{seconds[name]:.1f}s", flush=True)
    cleanup()
    return results, seconds, failed


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--only", default="",
                    help="comma-separated figure names "
                         f"({', '.join(n for n, _ in FIGURES)})")
    args = ap.parse_args(argv)
    quick = os.environ.get("FASTPERSIST_BENCH_FULL", "0") != "1"
    only = [s for s in args.only.split(",") if s] or None
    print("name,us_per_call,derived", flush=True)
    _, _, failed = run_all(quick, args.device, only)
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
