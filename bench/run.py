"""The benchmark's one command:

    python3 bench/run.py --workload CELL --seed N --seconds S --trace 0|1

finds the cell in ``bench/workloads/CELL.json``, its configuration in
``bench/configs/``, its traffic mix's parameters in
``bench/traffic/<traffic>.json``, the generator that mix names in
``bench/generators/<generator>.py`` and, with ``--trace 1``, each per-layer metric of ``BENCHMARK.json`` that the
cell reports in ``bench/metrics/<metric>.py``. It prints the compared
numbers beside their limits as the last lines of standard error (after a
line of the set-up's phases in seconds), the bytes it asked the program
to write on the line before the last of standard output, and the result
as one JSON object on the last line. A cell whose planned bytes, or a run
whose written bytes, exceed ``common.WRITE_BUDGET`` is refused.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
# every build and kernel cache of the program stays in the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)

from bench import common, extent, inputs  # noqa: E402


def planned_writes(cfg: dict, workload: dict) -> int:
    """Bytes the cell asks the program to write: its saves times one save
    (of the state, or of a rank mix's largest extent), with room for each
    save's manifest."""
    _, p = common.cell_params(workload)
    saves = p.get("saves", 0) + 1
    return saves * (extent.save_bytes(inputs.state_bytes(cfg), cfg, p)
                    + (1 << 20))


def metrics_for(spec: dict, kind: str, cell: str) -> list:
    return [m for m in spec[kind]
            if cell in m.get("workloads", [cell])]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    workload = common.load("workloads", args.workload)
    cfg = common.load("configs", workload["config"])
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    if planned_writes(cfg, workload) > common.WRITE_BUDGET:
        print(f"refused: {args.workload} would write "
              f"{planned_writes(cfg, workload)} bytes, over "
              f"{common.WRITE_BUDGET}", file=sys.stderr)
        return 2

    import torch
    chips = int(workload["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"refused: needs {chips} CUDA device(s), found {found}; this "
              "benchmark measures only on the card", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"refused: the program under test is missing ({e})",
              file=sys.stderr)
        return 3

    generator, params = common.cell_params(workload)
    traffic = common.module("generators", generator)
    t_run = time.perf_counter()
    base = os.environ.get("TMPDIR") or os.path.join(ROOT, ".bench_tmp")
    os.makedirs(base, exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="bench-ckpt-", dir=base)
    try:
        ctx = common.Ctx(config=cfg, params=params,
                         seed=args.seed, seconds=args.seconds,
                         trace=bool(args.trace), device="cuda:0",
                         ckpt_dir=ckpt)
        out = traffic.run(ctx)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)

    return report(args, spec, workload, cfg, out, t_run)


def report(args, spec: dict, workload: dict, cfg: dict, out: dict,
           t_run: float) -> int:
    """Holds a finished run to the write budget and the forbidden modules,
    then prints its result; returns the exit code."""
    if out["bytes_written"] > common.WRITE_BUDGET:
        print(f"refused: {args.workload} wrote {out['bytes_written']} "
              f"bytes, over {common.WRITE_BUDGET}", file=sys.stderr)
        return 6
    found = common.forbidden_loaded()
    if found:
        print(f"refused: the run loaded {found}", file=sys.stderr)
        return 4

    import torch
    chips = int(workload["chips"])
    setup_s = out["setup_end"] - T_PROCESS
    metrics = {}
    if args.trace:
        rec = dict(out["records"], config=cfg,
                   device=torch.cuda.get_device_name(0))
        for m in metrics_for(spec, "per_layer", args.workload):
            v = common.module("metrics", m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = dict(out["end_to_end"], setup_s=setup_s)
        for m in metrics_for(spec, "end_to_end", args.workload):
            if e2e.get(m["name"]) is None:
                print(f"no reading of {m['name']}", file=sys.stderr)
                return 5
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": all(c["ok"] for c in out["checks"]),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    tr = out["records"].get("trace")
    if args.trace:
        if not tr:
            print("the traced run recorded no device stretch",
                  file=sys.stderr)
            return 5
        device["busy_s"], device["window_s"] = tr["busy_s"], tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in out["checks"]}
    print(f"bytes_written {out['bytes_written']} of "
          f"{common.WRITE_BUDGET} allowed (setup_s {setup_s:.3f})")
    print(json.dumps(result))
    sys.stdout.flush()
    phases = dict(imports_and_context=t_run - T_PROCESS,
                  **out.get("setup_phases", {}))
    print("setup " + " ".join(f"{k} {v:.3f}" for k, v in phases.items()),
          file=sys.stderr)
    for c in out["checks"]:
        print(f"check {c['name']} {c['value']} limit {c['limit']} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
