"""Quickstart of the PyTorch port (the counterpart of
``examples/quickstart.py``, plus ``--device``): train a reduced model
with per-iteration FastPersist checkpointing through the unified
CheckpointEngine (pipelined backend), interrupt, restore, continue.

    PYTHONPATH=src python -m repro_torch.launch.quickstart      # cuda
    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu

Runs on the CUDA card unless ``--device cpu`` is given; asking for cuda
without a card raises.
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.configs import get_config, reduced
from repro_torch.core.checkpointer import FastPersistConfig
from repro_torch.core.partition import Topology
from repro_torch.train.trainer import (CheckpointPolicy, Trainer,
                                       TrainerConfig, resolve_device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises when CUDA is "
                         "unavailable — pass cpu explicitly)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduced(get_config("stablelm_1_6b"))
    with tempfile.TemporaryDirectory() as d:
        tc = TrainerConfig(
            model=cfg, steps=10, global_batch=4, seq_len=64, log_every=2,
            checkpoint=CheckpointPolicy(
                directory=d, every=1, backend="fastpersist-pipelined",
                fp=FastPersistConfig(
                    strategy="replica",
                    topology=Topology(dp_degree=4, ranks_per_node=2))))

        print(f"=== training 6 steps with per-iteration checkpointing on "
              f"{device} ===")
        t = Trainer(TrainerConfig(**{**tc.__dict__, "steps": 6}),
                    device=device)
        t.run()
        t.engine.close()
        print(f"checkpoint stall total: {t.ckpt_stall*1e3:.1f} ms")

        print("=== 'interruption' → restore → continue to step 10 ===")
        t2 = Trainer(tc, device=device)
        start = t2.restore()
        print(f"restored at step {start} "
              f"(data position {t2.data.position})")
        state, metrics = t2.run(start_step=start)
        t2.engine.close()
        loss = float(metrics["loss"])
        print(f"final loss {loss:.4f}")
    return start, loss


if __name__ == "__main__":
    main()
