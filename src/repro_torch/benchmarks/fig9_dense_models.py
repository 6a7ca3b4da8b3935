"""Paper Fig. 9: dense GPT-3 models — (a) checkpoint speedup vs baseline,
(c/d) end-to-end training speedup with per-iteration checkpointing (the
counterpart of ``benchmarks/fig9_dense_models.py``).

Checkpoint payloads are the paper's sizes scaled by 1/SCALE, drawn on
``device``; write measurements are real (device → host → disk), and the
iteration times come from the §3.2 estimator at the peak of the PAPER's
hardware (its V100s), since the figure projects the paper's cluster."""
import os
import shutil

from repro_torch.benchmarks.common import (bench_dir, cleanup, emit,
                                           resolve_device, sync,
                                           synth_state)
from repro_torch.configs import PAPER_TABLE2, get_paper_config
from repro_torch.core.checkpointer import FastPersistConfig
from repro_torch.core.engine import CheckpointEngine, CheckpointSpec
from repro_torch.core.overlap import effective_overhead, estimate_iteration
from repro_torch.core.partition import Topology
from repro_torch.core.writer import WriterConfig

SCALE = 64          # paper checkpoint GB / SCALE written for real
#: the paper's hardware (its Fig. 9 cluster of V100s): dense fp16
#: tensor-core peak, FLOP/s, per the vendor's data sheet
PAPER_V100_FP16_FLOPS = 125e12
#: the paper's cluster: GPUs
TOTAL_GPUS = 128

MODELS = ["gpt3_0_7b", "gpt3_1_3b", "gpt3_2_7b", "gpt3_6_7b", "gpt3_13b"]


def payload_bytes(key: str) -> int:
    """The bytes this figure writes for ``key``: the paper's checkpoint
    over SCALE."""
    return PAPER_TABLE2[key]["ckpt_gb"] * 10**9 // SCALE


def save_pair(state, d: str, n_writers: int):
    """Save ``state`` once through the baseline and once through
    FastPersist (``n_writers`` replica writers) under ``d``; returns the
    two SaveStats. The checkpoints stay under ``d/bl`` and ``d/fp``."""
    with CheckpointEngine(CheckpointSpec(
            directory=os.path.join(d, "bl"), backend="baseline")) as eng:
        sb = eng.save(state, 0).result()
    with CheckpointEngine(CheckpointSpec(
            directory=os.path.join(d, "fp"), backend="fastpersist",
            fp=FastPersistConfig(
                strategy="replica",
                topology=Topology(dp_degree=n_writers, ranks_per_node=8),
                writer=WriterConfig()))) as eng:
        sf = eng.save(state, 0).result()
    return sb, sf


def project(key: str, bl_gbps: float, fp_gbps: float, n_writers: int):
    """Fig. 9c: the measured write rates extrapolated to the paper's DP,
    the iteration time from the estimator at the V100 peak. Returns
    (iteration model, FastPersist overhead, baseline overhead, e2e
    speedup)."""
    cfg = get_paper_config(key)
    meta = PAPER_TABLE2[key]
    dp = TOTAL_GPUS // meta["mp"]
    ck_bytes = meta["ckpt_gb"] * 10**9
    it = estimate_iteration(cfg, meta["gbs"], 2048, TOTAL_GPUS,
                            peak_flops=PAPER_V100_FP16_FLOPS, mfu=0.4)
    per_writer_gbps = fp_gbps / n_writers
    t_fp = ck_bytes / (per_writer_gbps * 1e9 * dp)
    # baseline writes one file per MP slice in parallel (§2.1.1)
    t_bl = ck_bytes / (bl_gbps * 1e9 * meta["mp"])
    ov_fp = effective_overhead(it, t_fp, pipelined=True)
    ov_bl = effective_overhead(it, t_bl, pipelined=False)
    return it, ov_fp, ov_bl, (1 + ov_bl) / (1 + ov_fp)


def run(quick=True, device="cuda"):
    device = resolve_device(device)
    out = {}
    models = MODELS if not quick else MODELS[:3]
    for key in models:
        dp = TOTAL_GPUS // PAPER_TABLE2[key]["mp"]
        state = synth_state(payload_bytes(key) / 2**20, device)
        sync(device)
        d = os.path.join(bench_dir(), f"f9_{key}")
        n_writers = min(dp, 8)           # this box: kernel I/O parallelism
        sb, sf = save_pair(state, d, n_writers)
        shutil.rmtree(d, ignore_errors=True)
        del state
        speedup = sb.seconds / sf.seconds
        emit(f"fig9a/{key}_ckpt_speedup", sf.seconds,
             f"{speedup:.1f}x_dp{dp}_writers{n_writers}")
        it, _, _, e2e = project(key, sb.gbps, sf.gbps, n_writers)
        out[key] = (speedup, e2e)
        emit(f"fig9c/{key}_e2e_speedup", it.total, f"{e2e:.1f}x")
    return out


if __name__ == "__main__":
    run()
    cleanup()
