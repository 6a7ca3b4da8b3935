"""End-to-end run of the PyTorch port (the counterpart of
``examples/train_100m.py``, plus ``--device`` and ``--reduced``): train
a ~100M-parameter GPT-3-Small-class model for a few hundred steps with
FastPersist checkpointing every iteration (the paper's target workload,
scaled to one machine).

    PYTHONPATH=src python -m repro_torch.launch.train_100m --steps 200
    PYTHONPATH=src python -m repro_torch.launch.train_100m --reduced \
        --steps 3 --batch 2 --seq 16 --device cpu

Then Eq. 1 for this run: the write rate that would hide a checkpoint
behind the measured iteration, beside the rate this run's saves reached.
Runs on the CUDA card unless ``--device cpu`` is given; asking for cuda
without a card raises.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile

import numpy as np

from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.core.checkpointer import FastPersistConfig
from repro_torch.core.overlap import IterationModel, required_bandwidth
from repro_torch.core.partition import Topology
from repro_torch.optim.adam import AdamConfig
from repro_torch.train.trainer import (CheckpointPolicy, Trainer,
                                       TrainerConfig, resolve_device)

# ~100M params: 12L × 768 (GPT-3 Small geometry, gated MLP off)
GPT3_SMALL = ModelConfig(
    name="gpt3-small-100m", arch_type="dense", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=3072, vocab_size=50257,
    gated_mlp=False, tie_embeddings=True,
    source="arXiv:2005.14165")
#: the paper's per-node write rate, its 8 NVMe SSDs in RAID-0 (§5.2.1);
#: not measured here
PAPER_NODE_GBPS = 24.8


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config (2 layers, d_model 256)")
    ap.add_argument("--dir", default=None,
                    help="checkpoint directory, emptied first (default: a "
                         "temporary directory, removed at the end)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises when CUDA is "
                         "unavailable — pass cpu explicitly)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = reduced(GPT3_SMALL) if args.reduced else GPT3_SMALL
    directory = args.dir or tempfile.mkdtemp(prefix="fastpersist_100m_")
    shutil.rmtree(directory, ignore_errors=True)

    print(f"params: {cfg.param_count()/1e6:.0f}M  "
          f"checkpoint: {cfg.checkpoint_bytes()/1e9:.2f} GB  on {device}")
    try:
        tr = Trainer(TrainerConfig(
            model=cfg, steps=args.steps, global_batch=args.batch,
            seq_len=args.seq, opt=AdamConfig(lr=6e-4, warmup_steps=50),
            log_every=20,
            checkpoint=CheckpointPolicy(
                directory=directory, every=1,
                backend="fastpersist-pipelined",
                fp=FastPersistConfig(
                    strategy="auto",
                    topology=Topology(dp_degree=8, ranks_per_node=4)))),
            device=device)
        state, metrics = tr.run()
        tr.engine.close()
        gbps = [h.result().gbps for h in tr.saves]
    finally:
        if args.dir is None:
            shutil.rmtree(directory, ignore_errors=True)
    # leave out the first iterations (warm-up) when there are enough
    it = np.asarray(tr.iter_times[5:] if len(tr.iter_times) > 5
                    else tr.iter_times)
    loss = float(metrics["loss"])
    print(f"\nfinal loss {loss:.4f}")
    print(f"iter time p50 {np.percentile(it, 50)*1e3:.0f} ms  "
          f"ckpt stall total {tr.ckpt_stall*1e3:.0f} ms "
          f"({100*tr.ckpt_stall/max(it.sum(), 1e-9):.1f}% of train time)")
    # Eq. 1 for THIS run: B_C needed vs what its saves reached
    fb = float(np.percentile(it, 50)) * 0.9
    bc = required_bandwidth(cfg.checkpoint_bytes(),
                            IterationModel(fb / 3, 2 * fb / 3, fb * 0.1))
    measured = float(np.median(gbps))
    print(f"Eq.1: hiding a {cfg.checkpoint_bytes()/1e9:.2f} GB ckpt behind "
          f"{fb*1e3:.0f} ms of compute needs {bc/1e9:.2f} GB/s; this run's "
          f"saves wrote at {measured:.2f} GB/s (median of {len(gbps)}), "
          f"the paper's 8-SSD nodes at {PAPER_NODE_GBPS} GB/s (the "
          f"paper's figure, not measured here)")
    return loss, bc, measured


if __name__ == "__main__":
    main()
