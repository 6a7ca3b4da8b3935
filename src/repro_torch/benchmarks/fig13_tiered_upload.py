"""Tiered durability overlap (DESIGN.md §8): does streaming shard upload
to the object tier stay off the training critical path? (the
counterpart of ``benchmarks/fig13_tiered_upload.py``).

The same synthetic training loop (compute + per-iteration checkpoint of
a state on ``device``) runs against (a) the local-only ``fastpersist``
backend and (b) the ``fastpersist-tiered`` backend uploading every
generation to a mock bucket, and reports

  * ``overhead_pct`` — added per-iteration wall time from the tier
    (< 5% is the acceptance bar; the enqueue is the only hot-path
    work),
  * ``overlap_pct`` — what fraction of total upload seconds ran
    concurrently with training iterations (≈100% when the WAN keeps
    up),
  * a full remote round-trip check: local shards deleted, restore via
    ``engine.load(tier="remote", device=...)`` onto ``device``,
    bit-exact.

Rows are persisted to ``experiments/torch/fig13.json``."""
import glob
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
from repro_torch.core.partition import Topology

#: the small f32 record beside the blob
HEAD = 977


def make_state(mb, device) -> dict:
    """The figure's state on ``device``: ``synth_bytes(mb, seed=13)``'s
    bytes and a 977-element f32 ``head``."""
    return {"blob": torch.from_numpy(synth_bytes(mb, seed=13)).to(device),
            "head": torch.arange(HEAD, dtype=torch.float32, device=device)}


def _loop(spec, state, steps, compute_s):
    """Synthetic per-iteration-checkpoint loop: 'compute', save, wait
    for the LOCAL commit only (the paper's durability point) — never
    for the upload. Returns (iter_times, train_wall, upload_tail,
    upload_busy, uploaded)."""
    iters = []
    with CheckpointEngine(spec) as eng:
        t_loop0 = time.perf_counter()
        for step in range(steps):
            t0 = time.perf_counter()
            time.sleep(compute_s)             # stands in for fwd/bwd/opt
            eng.save(state, step).wait()      # local durability point
            iters.append(time.perf_counter() - t0)
        t_train_done = time.perf_counter()
        eng.wait_uploaded()                   # flush the tier (off-loop)
        upload_tail = time.perf_counter() - t_train_done
        train_wall = t_train_done - t_loop0
        mgr = eng.upload_manager
        upload_busy = mgr.total.seconds if mgr is not None else 0.0
        uploaded = mgr.total.bytes_uploaded if mgr is not None else 0
    return iters, train_wall, upload_tail, upload_busy, uploaded


def run(quick=True, mb=64, smoke=False, device="cuda"):
    device = resolve_device(device)
    steps = 4 if smoke else (8 if quick else 16)
    compute_s = 0.02 if smoke else 0.05
    d = os.path.join(bench_dir(), "f13")
    prim = os.path.join(d, "prim")
    bucket = os.path.join(d, "bucket")
    vols = [os.path.join(d, "vol0"), os.path.join(d, "vol1")]
    if smoke:
        mb = min(mb, 8)
    state = make_state(mb, device)
    sync(device)
    out = {"mb": mb, "steps": steps}

    def spec(backend):
        return CheckpointSpec(
            directory=prim, backend=backend, volumes=vols,
            upload_store=(bucket if "tiered" in backend else None),
            fp=FastPersistConfig(strategy="replica",
                                 topology=Topology(dp_degree=4)))

    if not smoke:
        # (a) local-only reference loop
        iters_local, *_ = _loop(spec("fastpersist"), state, steps,
                                compute_s)
        shutil.rmtree(d, ignore_errors=True)
        out["iter_local_ms"] = round(float(np.mean(iters_local)) * 1e3, 2)

    # (b) tiered loop: every generation streams to the mock bucket
    iters_t, train_wall, upload_tail, upload_busy, uploaded = _loop(
        spec("fastpersist-tiered"), state, steps, compute_s)
    out["iter_tiered_ms"] = round(float(np.mean(iters_t)) * 1e3, 2)
    out["upload_bytes"] = uploaded
    out["upload_busy_s"] = round(upload_busy, 4)
    # upload seconds hidden under training = busy time minus whatever
    # spilled past the last iteration into the explicit flush
    out["overlap_pct"] = round(
        100.0 * max(upload_busy - upload_tail, 0.0)
        / max(upload_busy, 1e-9), 1)

    if not smoke:
        out["overhead_pct"] = round(
            100.0 * (out["iter_tiered_ms"] - out["iter_local_ms"])
            / max(out["iter_local_ms"], 1e-9), 2)
        verdict = ("supported" if out["overhead_pct"] < 5.0
                   else "refuted")
        emit("fig13/overhead_pct", train_wall,
             f"{out['overhead_pct']:+.2f}%,{verdict}")
        emit("fig13/overlap_pct", upload_busy,
             f"{out['overlap_pct']:.1f}%")
        out["verdict"] = verdict

    # the durability proof: wipe EVERY local copy, come back from the
    # bucket onto the device, bit-exact (CRC-verified on the way through)
    for root in [prim, *vols]:
        for p in glob.glob(os.path.join(root, "ckpt_*")):
            shutil.rmtree(p, ignore_errors=True)
    restore_spec = spec("fastpersist")
    restore_spec.upload_store = bucket
    with CheckpointEngine(restore_spec) as eng:
        t0 = time.perf_counter()
        restored, _ = eng.load(tier="remote", device=device)
        sync(device)
        t_hydrate = time.perf_counter() - t0
        ok = all(torch.equal(restored[k], state[k]) for k in state)
    out["roundtrip_ok"] = bool(ok)
    out["hydrate_s"] = round(t_hydrate, 4)
    emit("fig13/remote_roundtrip", t_hydrate, "ok" if ok else "MISMATCH")
    shutil.rmtree(d, ignore_errors=True)

    if not smoke:
        save_json("fig13", out)
    return out


if __name__ == "__main__":
    print(json.dumps(run(), indent=2))
    cleanup()
