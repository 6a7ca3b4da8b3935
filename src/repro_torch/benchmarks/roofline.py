"""Roofline table from the port's dry-run artifacts (the counterpart of
``benchmarks/roofline.py``).

Reads ``experiments/torch/dryrun/*.json`` (``python -m
repro_torch.launch.dryrun --all``; ``DRYRUN_DIR`` overrides the
directory) and prints, per (arch × shape × mesh): the compute, memory
(upper bound) and collective terms (s), the dominant term and
MODEL_FLOPS / counted FLOPs. Then it ranks the hillclimb candidates.

The port's dry run counts eager, unfused bytes, so its memory term is an
upper bound (``t_memory_upper_s``): it is printed, but it takes no part
in the maximum, in ``dominant`` or in any ranking — those read the
compute and collective terms only (launch/dryrun.py's ``memory_term``).
A pair counted under ``shard_map_moe`` keys its row with ``/ep``."""
import glob
import json
import os

from repro_torch.benchmarks.common import EXPERIMENTS, emit, resolve_device


def dryrun_dir() -> str:
    """Where the dry run's JSON lies (read at each call)."""
    return os.environ.get("DRYRUN_DIR", os.path.join(EXPERIMENTS, "dryrun"))


def row_key(r) -> str:
    """A row's key: arch/shape/mesh, and ``/ep`` for a dry run under
    ``shard_map_moe`` (the port's dry run records it; the same pair may
    be counted both ways)."""
    return (f"{r['arch']}/{r['shape']}/{r['mesh']}"
            + ("/ep" if r.get("shard_map_moe") else ""))


def load_all():
    rows = []
    for p in sorted(glob.glob(os.path.join(dryrun_dir(), "*.json"))):
        with open(p) as f:
            r = json.load(f)
        if r.get("skipped") or "error" in r:
            continue
        rows.append(r)
    return rows


def run(quick=True, device="cuda"):
    resolve_device(device)
    rows = load_all()
    if not rows:
        print("roofline/no_dryrun_artifacts,0.0,run_dryrun_first")
        return {}
    out = {}
    for r in rows:
        key = row_key(r)
        tc, tu, tl = (r["t_compute_s"], r["t_memory_upper_s"],
                      r["t_collective_s"])
        dom = r["dominant"]
        ratio = r.get("useful_flops_ratio", 0.0)
        out[key] = (tc, tu, tl, dom, ratio)
        emit(f"roofline/{key}", max(tc, tl),
             f"c{tc:.3g}s_mu{tu:.3g}s_x{tl:.3g}s_dom:{dom}_useful{ratio:.2f}")

    pod = [r for r in rows if r["mesh"] == "16x16"]
    if pod:
        worst = min(pod, key=lambda r: r.get("useful_flops_ratio", 1))
        collb = max(pod, key=lambda r: r["t_collective_s"]
                    / max(r["t_compute_s"], 1e-12))
        emit("roofline/hillclimb_worst_useful", 0.0,
             f"{worst['arch']}/{worst['shape']}")
        emit("roofline/hillclimb_most_collective", 0.0,
             f"{collb['arch']}/{collb['shape']}")
    return out


if __name__ == "__main__":
    run()
