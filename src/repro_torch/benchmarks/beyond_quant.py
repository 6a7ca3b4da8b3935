"""Beyond-paper: quantized-checkpoint mode (Check-N-Run-class) measured
through the full FastPersist write path — S_C shrinks ~3.5×, so Eq. 1's
required bandwidth shrinks by the same factor (the counterpart of
``benchmarks/beyond_quant.py``). The state is drawn on ``device``; on the
card each leaf's block amax comes from the ckpt_pack_blocks kernel."""
import os
import shutil

import torch

from repro_torch.benchmarks.common import (bench_dir, cleanup, emit,
                                           resolve_device, sync)
from repro_torch.core.checkpointer import FastPersistCheckpointer, \
    FastPersistConfig
from repro_torch.core.partition import Topology

#: the state's MiB in a quick and a full run
QUICK_MB, FULL_MB = 128, 512


def synth_moments(mb: float, device, seed: int = 0) -> dict:
    """The reference's state for this figure: ``p`` bf16 and ``mw`` f32
    normal, ``m`` normal × 1e-3, ``v`` |normal| × 1e-6."""
    n = int(mb * 2**20) // 14
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(dtype=torch.float32):
        return torch.randn(n, generator=g, device=device, dtype=dtype)
    return {"p": normal(torch.bfloat16), "mw": normal(),
            "m": normal() * 1e-3, "v": normal().abs() * 1e-6}


def run(quick=True, device="cuda"):
    device = resolve_device(device)
    mb = QUICK_MB if quick else FULL_MB
    state = synth_moments(mb, device)
    sync(device)
    out = {}
    for quantize in (False, True):
        d = os.path.join(bench_dir(), f"bq_{quantize}")
        fp = FastPersistCheckpointer(d, FastPersistConfig(
            strategy="replica", topology=Topology(dp_degree=2),
            quantize=quantize))
        stats = fp.save(state, 0)
        out[quantize] = stats
        shutil.rmtree(d, ignore_errors=True)
        tag = "int8" if quantize else "full"
        emit(f"beyond/quant_{tag}", stats.seconds,
             f"{stats.total_bytes/2**20:.0f}MB_{stats.gbps:.2f}GBps")
    ratio = out[False].total_bytes / out[True].total_bytes
    speed = out[False].seconds / out[True].seconds
    emit("beyond/quant_reduction", out[True].seconds,
         f"{ratio:.1f}x_smaller_{speed:.1f}x_faster_ckpt")
    return out


if __name__ == "__main__":
    run()
    cleanup()
