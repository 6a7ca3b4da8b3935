"""Checkpoint serving read path (DESIGN.md §12): do parallel ranged
hydration, content-addressed dedup, and the hot-shard read cache pay?
(the counterpart of ``benchmarks/fig_serve.py``).

A trained checkpoint (a state saved from ``device``) is written once and
read many times — restarted trainers, eval jobs, inference fleets. This
figure drives the serving read path against a mock bucket with
bandwidth-proportional WAN latency per ranged GET (so byte striping
actually overlaps transfer time, like S3 ranged GETs do) and reports
four legs:

  * ``hydrate_r{1,2,4}_s`` — cold full hydration after a total local
    wipe at 1/2/4 range-fetch readers; ``speedup_4x`` (>= 2x is the
    acceptance bar) is serial over 4-reader wall time.
  * the dedup leg — re-saving an UNCHANGED state must re-upload
    metadata only (``dedup_metadata_only``): every payload shard
    dedupes against the first generation's ``cas/<digest>`` object.
  * the warm-cache leg — a second hydration through the read cache
    pulls ZERO bytes off the wire (``warm_fetched_bytes == 0``).
  * ``tensor_fetch_frac`` — ``engine.load_tensor(tier="remote",
    device=...)`` of one small tensor onto ``device``, wire bytes over
    checkpoint bytes (< 0.2 is the acceptance bar: serving one tensor
    must not hydrate the world); the tensor is held bit-exact.

Rows are persisted to ``experiments/torch/fig_serve.json``."""
import glob
import json
import os
import shutil
import time

import torch

from repro_torch.benchmarks.common import (bench_dir, cleanup, emit,
                                           resolve_device, save_json, sync,
                                           synth_bytes)
from repro_torch.core.checkpointer import FastPersistConfig
from repro_torch.core.engine import CheckpointEngine, CheckpointSpec
from repro_torch.core.partition import Topology
from repro_torch.core.upload import LocalObjectStore

#: the small f32 record beside the blob
HEAD = 611


class _WanStore(LocalObjectStore):
    """Mock bucket whose reads cost base latency + bytes/bandwidth —
    concurrent ranged GETs overlap (each sleeps on its own thread), so
    striping a big object across readers shortens the wall clock the
    way it does against a real object store."""

    def __init__(self, root, base_latency, gbps):
        super().__init__(root)
        self.base_latency = base_latency
        self.bw = gbps * 1e9

    def _toll(self, nbytes):
        time.sleep(self.base_latency + nbytes / self.bw)

    def get(self, key):
        data = super().get(key)
        self._toll(len(data))
        return data

    def get_to(self, key, path, offset=0, length=None):
        if length is None:
            length = (self.size(key) or 0) - offset
        self._toll(max(length, 0))
        super().get_to(key, path, offset=offset, length=length)


def _wipe_local(spec):
    for root in [spec.directory, *(spec.volumes or [])]:
        for p in glob.glob(os.path.join(root, "ckpt_*")):
            shutil.rmtree(p, ignore_errors=True)


def run(quick=True, mb=32, smoke=False, device="cuda"):
    device = resolve_device(device)
    if smoke:
        mb = min(mb, 8)
    base_latency = 0.002 if smoke else 0.01
    gbps = 0.2                                   # a ~200 MB/s WAN link
    d = os.path.join(bench_dir(), "fserve")
    prim = os.path.join(d, "prim")
    vols = [os.path.join(d, "vol0"), os.path.join(d, "vol1")]
    bucket = _WanStore(os.path.join(d, "bucket"), base_latency, gbps)
    state = {"blob": torch.from_numpy(synth_bytes(mb, seed=31)).to(device),
             "head": torch.arange(HEAD, dtype=torch.float32, device=device)}
    sync(device)
    out = {"mb": mb, "wan_base_ms": base_latency * 1e3,
           "wan_gbps": gbps}

    def _spec(cache_mb=0):
        return CheckpointSpec(
            directory=prim, backend="fastpersist-tiered", volumes=vols,
            upload_store=bucket, serve_cache_mb=cache_mb,
            fp=FastPersistConfig(strategy="replica",
                                 topology=Topology(dp_degree=4)))

    # ------------------------------------------- dedup leg (2 saves)
    spec = _spec()
    with CheckpointEngine(spec) as eng:
        st1 = eng.save(state, 1).wait_uploaded()
        st2 = eng.save(state, 2).wait_uploaded()  # identical bytes
    out["dedup_uploaded_objects"] = st2.n_uploaded
    out["dedup_bytes_saved"] = st2.bytes_deduped
    # only the manifest (per-save nonce) may cross the wire again
    out["dedup_metadata_only"] = bool(
        st2.n_uploaded <= 1 and st2.bytes_deduped > 0
        and st2.n_deduped >= st1.n_objects - 1)
    emit("fig_serve/dedup_resave", 0.0,
         f"{st2.bytes_deduped}B_deduped,"
         f"{'ok' if out['dedup_metadata_only'] else 'LEAK'}")

    # ----------------------------- cold hydration sweep: 1/2/4 readers
    times = {}
    for readers in (1, 2, 4):
        _wipe_local(spec)
        with CheckpointEngine(spec) as eng:
            t0 = time.perf_counter()
            eng.hydrate_remote(readers=readers)
            times[readers] = time.perf_counter() - t0
            hs = eng.last_hydrate_stats
            assert hs.fetched_bytes > 0 and hs.reused_bytes == 0
        out[f"hydrate_r{readers}_s"] = round(times[readers], 4)
        emit(f"fig_serve/hydrate_r{readers}", times[readers],
             f"{hs.fetched_bytes}B")
    out["speedup_2x"] = round(times[1] / max(times[2], 1e-9), 2)
    out["speedup_4x"] = round(times[1] / max(times[4], 1e-9), 2)

    # ------------------------------- warm-cache leg: second hydration
    _wipe_local(spec)
    cspec = _spec(cache_mb=4 * mb)
    with CheckpointEngine(cspec) as eng:
        eng.hydrate_remote()                      # cold: fills the cache
        _wipe_local(cspec)
        t0 = time.perf_counter()
        eng.hydrate_remote()                      # warm: pure cache
        t_warm = time.perf_counter() - t0
        warm = eng.last_hydrate_stats
    out["hydrate_warm_s"] = round(t_warm, 4)
    out["warm_fetched_bytes"] = warm.fetched_bytes
    out["warm_hit_bytes"] = warm.cache_hit_bytes
    emit("fig_serve/hydrate_warm", t_warm,
         f"{warm.cache_hit_bytes}B_hit,{warm.fetched_bytes}B_fetched")

    # ------------------------- per-tensor serving leg (the small head)
    _wipe_local(cspec)
    shutil.rmtree(os.path.join(prim, ".serve-cache"), ignore_errors=True)
    with CheckpointEngine(cspec) as eng:
        t0 = time.perf_counter()
        head = eng.load_tensor("head", tier="remote", device=device)
        sync(device)
        t_tensor = time.perf_counter() - t0
        ts = eng.last_serve[-1]
    if not torch.equal(head, state["head"]):
        raise AssertionError("fig_serve: the served head differs from "
                             "the saved one")
    out["tensor_read_s"] = round(t_tensor, 4)
    out["tensor_bytes"] = ts.tensor_bytes
    out["tensor_fetched_bytes"] = ts.fetched_bytes
    out["ckpt_total_bytes"] = ts.total_bytes
    frac = ts.fetched_bytes / max(ts.total_bytes, 1)
    out["tensor_fetch_frac"] = round(frac, 4)
    emit("fig_serve/tensor_read", t_tensor, f"frac={frac:.3f}")

    ok = (out["speedup_4x"] >= 2.0 and frac < 0.2
          and out["dedup_metadata_only"]
          and warm.fetched_bytes == 0)
    out["verdict"] = "supported" if ok else "refuted"
    emit("fig_serve/verdict", 0.0, out["verdict"])
    shutil.rmtree(d, ignore_errors=True)

    if not smoke:
        save_json("fig_serve", out)
    return out


if __name__ == "__main__":
    print(json.dumps(run(), indent=2))
    cleanup()
