"""Readings that set a cell's limits, taken on the chip at the cell's own
size (the benchmark's runs never run this):

    python3 bench/control.py --workload <cell> [--sound 12] [--faulty 3]

``--sound`` seeds of the program as the configuration states it (the
set-up's steps against the reference: the lower readings), then, on
``--faulty`` seeds, the two controls and each fault of ``bench/faults.py``:
``control_step``, the reference in the program's place with its weights,
master weights and moments in bfloat16 (``train_ckpt.control_step``);
``control_ckpt``, the program's own lower-precision path, int8-quantized
checkpoints, a whole run with no measured window; and each fault, a whole
run likewise (``faults.variants``). One JSON line per reading on
standard output.
"""
import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from bench import common, faults  # noqa: E402
from bench.generators import train_ckpt  # noqa: E402

EVERY = {k: float("inf") for k in ("loss_gap", "grad_gap", "delta_gap")}


def reading(ctx, variant: str, seed: int):
    t = time.perf_counter()
    if variant == "sound":
        trainer, w0 = train_ckpt.build(ctx, ctx.params["backend"], {})
        n = ctx.params.get("warm_steps", 1)
        prog = train_ckpt.warm_up(ctx, trainer, w0, n)
        train_ckpt.release(ctx, trainer)
        ref = {}
        checks = train_ckpt.compare(ctx, w0, prog, n, EVERY, ref)
        kept = common.moving_leaves(ref["grad"])
        checks.append({"name": "delta_leaves_left_out",
                       "value": sorted(set(ref["grad"]) - kept)})
    elif variant == "control_step":
        checks = train_ckpt.control_step(ctx, EVERY)
    elif variant == "control_ckpt":
        ctx.params["fp"] = {"quantize": True}
        checks = train_ckpt.run(ctx)["checks"]
    else:
        with faults.FAULTS[variant]():
            checks = train_ckpt.run(ctx)["checks"]
    return {"seed": seed, "variant": variant,
            "seconds": time.perf_counter() - t,
            **{c["name"]: c["value"] for c in checks}}


def main():
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--sound", type=int, default=12)
    ap.add_argument("--faulty", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_017)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("the control readings are taken on the card")
    wl = common.load("workloads", args.workload)
    cfg = common.load("configs", wl["config"])
    plan = [("sound", args.first_seed + i) for i in range(args.sound)]
    variants = faults.variants(common.cell_params(wl)[1])
    for i in range(args.faulty):
        seed = args.first_seed + 1000 + i
        plan += [(v, seed) for v in variants]
    base = os.environ.get("TMPDIR") or os.path.join(ROOT, ".bench_tmp")
    os.makedirs(base, exist_ok=True)
    for variant, seed in plan:
        d = tempfile.mkdtemp(prefix="bench-control-", dir=base)
        params = dict(common.cell_params(wl)[1], saves=0)
        ctx = common.Ctx(config=cfg, params=params, seed=seed,
                         seconds=0.0, trace=False, device="cuda:0",
                         ckpt_dir=d)
        try:
            row = reading(ctx, variant, seed)
        except Exception as e:     # noqa: BLE001 - a crash is a reading
            row = {"seed": seed, "variant": variant, "error": repr(e)}
        finally:
            shutil.rmtree(d, ignore_errors=True)
            torch.cuda.empty_cache()
        print(json.dumps({"cell": args.workload, **row}), flush=True)


if __name__ == "__main__":
    main()
