"""Peer-replication durability tier (DESIGN.md §11): does
``wait_replicated`` land orders of magnitude before ``wait_uploaded``?
(the counterpart of ``benchmarks/fig_peer.py``).

The same per-iteration checkpoint loop (a state on ``device``) runs
against both tiers at once: a ``fastpersist-tiered`` engine whose upload
store is a mock bucket with injected WAN latency per object, plus three
fast local peer stores in distinct failure domains, and reports per save

  * ``t_replicated_ms`` / ``t_uploaded_ms`` — time from the local
    commit to peer-tier resp. remote-tier durability,
  * ``tier_gap_x`` — their median ratio (>= 10x is the acceptance
    bar: the peer tier must be at least an order of magnitude ahead),
  * the failover proof: one peer killed AND every local shard deleted,
    ``engine.load(tier="peer", device=...)`` restores bit-exactly onto
    ``device`` from a survivor.

Rows are persisted to ``experiments/torch/fig_peer.json``."""
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
from repro_torch.core.peer import PeerConfig
from repro_torch.core.upload import LocalObjectStore

#: the small f32 record beside the blob
HEAD = 611


class _WanStore(LocalObjectStore):
    """Mock bucket with injected WAN latency per object put."""

    def __init__(self, root, latency):
        super().__init__(root)
        self.latency = latency

    def put(self, key, data):
        time.sleep(self.latency)
        super().put(key, data)

    def put_file(self, key, path):
        time.sleep(self.latency)
        super().put_file(key, path)


class _DeadableStore(LocalObjectStore):
    """Peer store with a kill switch (the failover leg)."""

    dead = False

    def _gate(self):
        if self.dead:
            raise IOError(f"dead peer store: {self.root}")

    def put(self, key, data):
        self._gate()
        super().put(key, data)

    def put_file(self, key, path):
        self._gate()
        super().put_file(key, path)

    def get(self, key):
        self._gate()
        return super().get(key)

    def exists(self, key):
        self._gate()
        return super().exists(key)

    def size(self, key):
        self._gate()
        return super().size(key)

    def list(self, prefix=""):
        self._gate()
        return super().list(prefix)


def run(quick=True, mb=32, smoke=False, device="cuda"):
    device = resolve_device(device)
    steps = 3 if smoke else (6 if quick else 12)
    wan_latency = 0.02 if smoke else 0.1
    if smoke:
        mb = min(mb, 4)
    d = os.path.join(bench_dir(), "fpeer")
    prim = os.path.join(d, "prim")
    vols = [os.path.join(d, "vol0"), os.path.join(d, "vol1")]
    bucket = _WanStore(os.path.join(d, "bucket"), wan_latency)
    peers = [PeerConfig(name=f"n{i}",
                        store=_DeadableStore(os.path.join(d, f"peer{i}")),
                        failure_domain=f"rack{i}") for i in range(3)]
    state = {"blob": torch.from_numpy(synth_bytes(mb, seed=29)).to(device),
             "head": torch.arange(HEAD, dtype=torch.float32, device=device)}
    sync(device)
    out = {"mb": mb, "steps": steps, "wan_latency_ms": wan_latency * 1e3}

    spec = CheckpointSpec(
        directory=prim, backend="fastpersist-tiered", volumes=vols,
        upload_store=bucket, peers=peers, replication_factor=2,
        failure_domain="rack-writer",
        fp=FastPersistConfig(strategy="replica",
                             topology=Topology(dp_degree=4)))

    t_rep, t_up = [], []
    with CheckpointEngine(spec) as eng:
        for step in range(steps):
            h = eng.save(state, step)
            h.wait()                              # local durability
            t0 = time.perf_counter()
            rs = h.wait_replicated()              # peer durability
            t_rep.append(time.perf_counter() - t0)
            assert rs.committed and not rs.under_replicated
            h.wait_uploaded()                     # remote durability
            t_up.append(time.perf_counter() - t0)
    med_rep = float(np.median(t_rep))
    med_up = float(np.median(t_up))
    out["t_replicated_ms"] = round(med_rep * 1e3, 3)
    out["t_uploaded_ms"] = round(med_up * 1e3, 3)
    out["tier_gap_x"] = round(med_up / max(med_rep, 1e-9), 1)
    verdict = "supported" if out["tier_gap_x"] >= 10.0 else "refuted"
    out["verdict"] = verdict
    emit("fig_peer/tier_gap", med_up, f"{out['tier_gap_x']}x,{verdict}")

    # failover proof: one peer dies, every local shard is wiped — the
    # restore must come back onto the device bit-exact from a survivor
    peers[0].store.dead = True
    for root in [prim, *vols]:
        for p in glob.glob(os.path.join(root, "ckpt_*")):
            shutil.rmtree(p, ignore_errors=True)
    with CheckpointEngine(spec) as eng:
        t0 = time.perf_counter()
        restored, _ = eng.load(tier="peer", device=device)
        sync(device)
        t_failover = time.perf_counter() - t0
        ok = all(torch.equal(restored[k], state[k]) for k in state)
    out["failover_ok"] = bool(ok)
    out["failover_restore_s"] = round(t_failover, 4)
    emit("fig_peer/failover_restore", t_failover,
         "ok" if ok else "MISMATCH")
    shutil.rmtree(d, ignore_errors=True)

    if not smoke:
        save_json("fig_peer", out)
    return out


if __name__ == "__main__":
    print(json.dumps(run(), indent=2))
    cleanup()
