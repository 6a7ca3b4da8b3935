"""Model FLOPs of the window's completed steps (``bench/flops.py``) over
their time, as a share of the device's published bf16 peak. Steps run
while the profiler recorded are left out, with their time: the profiler
slows them."""
from bench import flops


def read(rec):
    peak = flops.peak(rec["device"])
    if not peak or not rec.get("untraced_steps"):
        return None
    cfg = rec["config"]
    f = flops.train_flops_per_step(cfg, cfg["rows_per_step"])
    return 100.0 * f * rec["untraced_steps"] / rec["untraced_s"] / peak
