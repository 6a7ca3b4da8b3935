"""FastPersist against the baseline checkpoint write on a synthetic
training state (a small paper Fig. 9a on this machine's disk), through
the unified CheckpointEngine — the counterpart of
``examples/fastpersist_vs_baseline.py``, plus ``--device`` and ``--dir``.

    PYTHONPATH=src python -m repro_torch.launch.fastpersist_vs_baseline \
        --mb 1024                                    # state on cuda
    PYTHONPATH=src python -m repro_torch.launch.fastpersist_vs_baseline \
        --mb 64 --device cpu

The state (bf16 params, f32 master weights and Adam moments: 14 B a
parameter, the paper's §2.1.3) is drawn on the device from a seeded
``torch.Generator``. Each variant saves it once into its own directory
under ``--dir``, which is removed after the save, so the disk holds one
state at a time. Prints the GB/s measured here; a save that fails
raises. Runs on the CUDA card unless ``--device cpu`` is given; asking
for cuda without a card raises.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time

import torch

from repro_torch.core.checkpointer import FastPersistConfig
from repro_torch.core.engine import CheckpointEngine, CheckpointSpec
from repro_torch.core.partition import Topology
from repro_torch.core.writer import WriterConfig
from repro_torch.train.trainer import resolve_device


def synth_state(mb: int, device, seed: int = 0):
    """About ``mb`` MiB of state at 14 B a parameter, on ``device``."""
    n = mb * 1024 * 1024 // 14
    gen = torch.Generator(device=device).manual_seed(seed)
    return {
        "params": torch.randn(n, generator=gen, device=device)
        .to(torch.bfloat16),
        "master": torch.randn(n, generator=gen, device=device),
        "m": torch.zeros(n, device=device),
        "v": torch.ones(n, device=device),
    }


def _save(spec: CheckpointSpec, state):
    """One save through a fresh engine; returns (its SaveStats, the
    seconds ``save`` took to return)."""
    try:
        with CheckpointEngine(spec) as eng:
            t0 = time.perf_counter()
            handle = eng.save(state, 0)
            t_submit = time.perf_counter() - t0
            return handle.result(), t_submit
    finally:
        shutil.rmtree(spec.directory, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the state (default cuda; raises "
                         "when CUDA is unavailable — pass cpu explicitly)")
    ap.add_argument("--dir", default=".",
                    help="where the checkpoints are written (a temporary "
                         "directory is made inside it)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    state = synth_state(args.mb, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    n_bytes = sum(t.numel() * t.element_size() for t in state.values())
    print(f"state: {n_bytes} B on {device}")

    results = {}
    with tempfile.TemporaryDirectory(dir=args.dir) as d:
        s0, _ = _save(CheckpointSpec(directory=os.path.join(d, "bl"),
                                     backend="baseline"), state)
        results["baseline"] = s0
        print(f"baseline (torch.save-like):      {s0.gbps:6.2f} GB/s")

        for writers in (1, 4, 8):
            s, _ = _save(CheckpointSpec(
                directory=os.path.join(d, f"fp{writers}"),
                backend="fastpersist",
                fp=FastPersistConfig(
                    strategy="replica",
                    topology=Topology(dp_degree=writers, ranks_per_node=4),
                    writer=WriterConfig(double_buffer=True))), state)
            results[f"fastpersist {writers} writers"] = s
            print(f"fastpersist {writers} writer{'s' if writers > 1 else ' '}"
                  f" (double-buf): {s.gbps:6.2f} GB/s  speedup "
                  f"{s.gbps / s0.gbps:5.1f}x")

        stats, t_submit = _save(CheckpointSpec(
            directory=os.path.join(d, "fpp"),
            backend="fastpersist-pipelined",
            fp=FastPersistConfig(
                strategy="replica",
                topology=Topology(dp_degree=4, ranks_per_node=4))), state)
        results["fastpersist-pipelined"] = stats
        print(f"pipelined submit cost: {t_submit*1e3:.2f} ms "
              f"(write ran off the critical path at {stats.gbps:.2f} GB/s, "
              f"commit {stats.commit_seconds*1e3:.1f} ms)")
    return results, t_submit


if __name__ == "__main__":
    main()
