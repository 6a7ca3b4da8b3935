"""Incremental delta checkpoints (DESIGN.md §9): bytes written and save
latency vs full per-iteration checkpoints (the counterpart of
``benchmarks/fig_delta.py``).

Every Nth save is a full keyframe, the rest write only the dirty byte
spans the arena's blockwise tracker found. The same sparse-update
training stand-in (a ``dirty_frac`` fraction of a model blob on
``device`` touched per step) runs across keyframe cadences and dirty
fractions, and each cell reports

  * ``bytes_x`` — total bytes written by the full-checkpoint loop over
    the delta loop (>= 5x on the sparse workload is the bar),
  * ``save_ms_full`` / ``save_ms_delta`` — mean save wall time,
  * a bit-exactness check: the restore of each chain (onto ``device``)
    equals the live state byte for byte.

Rows are persisted to ``experiments/torch/fig_delta.json``."""
import json
import os
import shutil
import time

import numpy as np
import torch

from repro_torch.benchmarks.common import (bench_dir, cleanup, emit,
                                           resolve_device, save_json, sync,
                                           synth_bytes)
from repro_torch.core.checkpointer import FastPersistConfig
from repro_torch.core.engine import CheckpointEngine, CheckpointSpec

PAGE = 4096


def _touch(state, rng, dirty_frac):
    """Sparse in-place update: rewrite ``dirty_frac`` of the blob's
    4 KiB pages (the embedding-row / frozen-layer access pattern); the
    pages are the reference's draw from ``rng``."""
    blob = state["blob"]
    pages = blob.numel() // PAGE
    n = max(1, int(pages * dirty_frac))
    idx = rng.choice(pages, size=n, replace=False)
    rows = blob[:pages * PAGE].view(pages, PAGE)
    rows[torch.from_numpy(idx).to(blob.device)] ^= 0x5A
    state["step_ctr"] += 1


def run(quick=True, mb=32, smoke=False, device="cuda"):
    device = resolve_device(device)
    steps = 4 if smoke else (8 if quick else 16)
    if smoke:
        mb = min(mb, 4)
    d = os.path.join(bench_dir(), "fdelta")
    out = {"mb": mb, "steps": steps, "cells": []}
    cadences = [8] if smoke else [4, 8]
    fracs = [0.01] if smoke else [0.01, 0.1]
    for dirty_frac in fracs:
        for kf in cadences:
            cell = {"keyframe_every": kf, "dirty_frac": dirty_frac}
            for mode, kf_eff in (("full", 1), ("delta", kf)):
                rng = np.random.default_rng(17)
                state = {"blob": torch.from_numpy(
                             synth_bytes(mb, seed=17)).to(device),
                         "step_ctr": torch.zeros(1, dtype=torch.int64,
                                                 device=device)}
                dd = os.path.join(d, f"{mode}-{kf}-{dirty_frac}")
                shutil.rmtree(dd, ignore_errors=True)
                btot, stimes = 0, []
                spec = CheckpointSpec(
                    directory=dd, backend="fastpersist",
                    fp=FastPersistConfig(strategy="replica",
                                         keyframe_every=kf_eff))
                with CheckpointEngine(spec) as eng:
                    # save 0 primes the arena (always a keyframe);
                    # saves 1..steps are the measured steady state
                    eng.save(state, 0).wait()
                    for step in range(1, steps + 1):
                        _touch(state, rng, dirty_frac)
                        sync(device)
                        t0 = time.perf_counter()
                        st = eng.save(state, step).wait()
                        stimes.append(time.perf_counter() - t0)
                        btot += st.total_bytes
                    restored, _ = eng.load(step=steps, like=state,
                                           device=device)
                    ok = all(torch.equal(restored[k], state[k])
                             for k in state)
                cell[f"bytes_{mode}"] = btot
                cell[f"save_ms_{mode}"] = round(
                    float(np.mean(stimes)) * 1e3, 3)
                cell[f"ok_{mode}"] = bool(ok)
                shutil.rmtree(dd, ignore_errors=True)
            cell["bytes_x"] = round(
                cell["bytes_full"] / max(cell["bytes_delta"], 1), 2)
            cell["save_x"] = round(
                cell["save_ms_full"] / max(cell["save_ms_delta"], 1e-9), 2)
            emit(f"fig_delta/kf{kf}_dirty{dirty_frac}",
                 cell["save_ms_delta"] / 1e3,
                 f"{cell['bytes_x']}x_bytes,{cell['save_x']}x_save")
            out["cells"].append(cell)
    # the bar: on the sparse (1% dirty) workload the best cadence must
    # cut bytes written >= 5x vs full checkpoints — every Nth save is
    # still a full keyframe, so a cadence of N caps the reduction near N
    best_sparse = max((c["bytes_x"] for c in out["cells"]
                       if c["dirty_frac"] <= 0.01), default=0.0)
    all_ok = all(c["ok_full"] and c["ok_delta"] for c in out["cells"])
    out["best_sparse_bytes_x"] = best_sparse
    out["verdict"] = ("supported" if best_sparse >= 5.0 and all_ok
                      else "refuted")
    emit("fig_delta/verdict", 0.0, out["verdict"])
    shutil.rmtree(d, ignore_errors=True)
    if not smoke:
        save_json("fig_delta", out)
    return out


if __name__ == "__main__":
    print(json.dumps(run(), indent=2))
    cleanup()
