"""Training launcher of the PyTorch port (the flags of
``repro.launch.train`` plus ``--device``, less ``--ckpt-mode``,
``--pipeline`` and ``--no-arena``: ``--backend`` names the engine's
backend, or ``none``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm_1_6b \
        --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt --every 1 \
        --keyframe-every 2 --device-dirty            # --device cuda

Runs on the CUDA card unless ``--device cpu`` is given; asking for cuda
without a card raises. The durability tiers take the reference's flags
and defaults: ``--upload-store``, ``--peers``, ``--replication-factor``,
``--failure-domain``, ``--hydrate-readers``, ``--serve-cache-mb`` and
``--restore-tier``.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config, reduced as make_reduced
from repro_torch.core.checkpointer import FastPersistConfig
from repro_torch.core.engine import available_backends
from repro_torch.core.partition import Topology
from repro_torch.core.writer import WriterConfig
from repro_torch.optim.adam import AdamConfig
from repro_torch.train.trainer import CheckpointPolicy, Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; raises "
                         "when CUDA is unavailable — pass cpu explicitly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--gas", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--backend", default=None,
                    choices=[*available_backends(), "none"],
                    help="CheckpointEngine backend (default "
                         "fastpersist-pipelined, or "
                         "fastpersist-tiered-pipelined with "
                         "--upload-store); none saves nothing")
    ap.add_argument("--every", type=int, default=1)
    ap.add_argument("--keyframe-every", type=int, default=1,
                    help="incremental delta checkpoints: every Nth save "
                         "is a full keyframe, the rest write only the "
                         "byte ranges that changed since the previous "
                         "save (1 = every save is full)")
    ap.add_argument("--delta-quantize", action="store_true",
                    help="int8-quantize delta spans (lossy; blockwise "
                         "absmax scales, DESIGN.md §9) — keyframes stay "
                         "full-precision")
    ap.add_argument("--delta-stripe-min-mb", type=int, default=8,
                    help="stripe a delta generation across the full "
                         "writer/volume fan-out once its packed payload "
                         "reaches this many MiB (0 = always stripe)")
    ap.add_argument("--writers", default="auto",
                    choices=["auto", "replica", "socket"])
    ap.add_argument("--dp", type=int, default=4,
                    help="simulated DP degree for checkpoint writers")
    ap.add_argument("--volumes", default=None,
                    help="comma-separated shard destination volume roots")
    ap.add_argument("--io-backend", default="auto",
                    choices=["auto", "io_uring", "libaio", "pwrite"],
                    help="write-submission backend (capability-probed)")
    ap.add_argument("--queue-depth", type=int, default=2,
                    help="in-flight writes per writer stream")
    ap.add_argument("--snapshot-chunk-mb", type=int, default=8,
                    help="chunk size of the overlapped device→arena "
                         "snapshot (0 = monolithic)")
    ap.add_argument("--device-dirty", action="store_true",
                    help="compute delta dirty masks ON THE CARD (the "
                         "ckpt_pack_dirty CUDA kernel) so delta saves "
                         "move only dirty blocks over PCIe; costs one "
                         "device-resident copy of the packed state")
    ap.add_argument("--upload-store", default=None,
                    help="object-store spec for the second durability "
                         "tier (a directory path or file:// URL uses the "
                         "built-in mock bucket; registered scheme:// URLs "
                         "reach real stores). Selects the "
                         "fastpersist-tiered backends: sealed shards "
                         "stream to the store AFTER each local commit, "
                         "and --restore falls back to the store when the "
                         "local checkpoint directory is empty/lost")
    ap.add_argument("--peers", default=None,
                    help="comma-separated peer-replication targets "
                         "([name=]store[@failure_domain], e.g. "
                         "/mnt/peers/n1@rack0,/mnt/peers/n2@rack1): "
                         "after each local commit the sealed generation "
                         "streams to K peers in the background "
                         "(DESIGN.md §11); --restore falls back to the "
                         "peer tier when the local dir is lost")
    ap.add_argument("--replication-factor", type=int, default=2,
                    help="replicas each checkpoint should reach on the "
                         "peer tier (spread across distinct failure "
                         "domains when available)")
    ap.add_argument("--failure-domain", default=None,
                    help="this node's failure domain; peer placement "
                         "avoids it whenever another usable domain "
                         "exists")
    ap.add_argument("--hydrate-readers", type=int, default=4,
                    help="concurrent ranged-GET readers for remote/peer "
                         "hydration — missing bytes are byte-striped "
                         "this wide when the store supports ranged "
                         "reads (DESIGN.md §12)")
    ap.add_argument("--serve-cache-mb", type=int, default=0,
                    help="serving read-cache budget in MiB (0 = off): "
                         "hydration and per-tensor remote reads go "
                         "through a digest-keyed LRU block cache under "
                         "<ckpt-dir>/.serve-cache (DESIGN.md §12)")
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--restore-tier", default="local",
                    choices=["local", "peer", "remote"],
                    help="force --restore to hydrate from the peer tier "
                         "or the object store (remote) instead of local "
                         "NVMe")
    ap.add_argument("--restore-readers", default="auto",
                    help="parallel-restore reader workers: 'auto', an "
                         "integer, or 'none' for the single-reader load")
    args = ap.parse_args(argv)
    restore_readers = (None if args.restore_readers == "none"
                       else args.restore_readers if
                       args.restore_readers == "auto"
                       else int(args.restore_readers))

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)

    ckpt = None
    if args.ckpt_dir and args.backend != "none":
        ckpt = CheckpointPolicy(
            directory=args.ckpt_dir, every=args.every, backend=args.backend,
            volumes=(args.volumes.split(",") if args.volumes else None),
            restore_readers=restore_readers,
            upload_store=args.upload_store,
            peers=(args.peers.split(",") if args.peers else None),
            replication_factor=args.replication_factor,
            failure_domain=args.failure_domain,
            hydrate_readers=args.hydrate_readers,
            serve_cache_mb=args.serve_cache_mb,
            fp=FastPersistConfig(
                strategy=args.writers,
                topology=Topology(dp_degree=args.dp, ranks_per_node=4),
                keyframe_every=args.keyframe_every,
                snapshot_chunk_mb=args.snapshot_chunk_mb,
                device_dirty=args.device_dirty,
                delta_quantize=args.delta_quantize,
                delta_stripe_min_mb=args.delta_stripe_min_mb,
                writer=WriterConfig(backend=args.io_backend,
                                    queue_depth=args.queue_depth)))

    tr = Trainer(TrainerConfig(
        model=cfg, steps=args.steps, global_batch=args.batch,
        seq_len=args.seq, gas=args.gas, opt=AdamConfig(lr=args.lr),
        checkpoint=ckpt), device=args.device)

    start = 0
    if args.restore and ckpt:
        start = tr.restore(tier=args.restore_tier)
        print(f"restored from step {start}")
    state, metrics = tr.run(start_step=start)
    print(f"done: loss={float(metrics.get('loss', float('nan'))):.4f} "
          f"mean_iter={np.mean(tr.iter_times)*1e3:.1f}ms "
          f"ckpt_stall={tr.ckpt_stall*1e3:.1f}ms")


if __name__ == "__main__":
    main()
