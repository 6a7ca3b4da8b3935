"""Paper Fig. 2: baseline (torch.save-style) SSD bandwidth utilization —
measured on this machine as % of its own peak write bandwidth (the
counterpart of ``benchmarks/fig2_baseline_util.py``). The state is drawn
on ``device``; the baseline copies it to the host and writes it."""
import os

from repro_torch.benchmarks.common import (bench_dir, cleanup, drop_file,
                                           emit, measure_peak_write_gbps,
                                           resolve_device, sync,
                                           synth_state)
from repro_torch.core.baseline import BaselineCheckpointer


def run(quick=True, device="cuda"):
    device = resolve_device(device)
    peak = measure_peak_write_gbps(128 if quick else 512)
    emit("fig2/peak_write", 0.0, f"{peak:.2f}GBps")
    for mb in ([64, 256] if quick else [64, 256, 1024]):
        state = synth_state(mb, device)
        sync(device)
        bl = BaselineCheckpointer(os.path.join(bench_dir(), f"bl{mb}"))
        stats = bl.save(state, 0)
        util = 100.0 * stats.gbps / max(peak, 1e-9)
        emit(f"fig2/baseline_{mb}MB", stats.seconds,
             f"{stats.gbps:.2f}GBps={util:.0f}%of_peak")
        drop_file(bl.path(0))
    return peak


if __name__ == "__main__":
    run()
    cleanup()
