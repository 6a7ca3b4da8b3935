"""The MLA flash kernels' share of their roofline in the traced stretch:
the time the stretch's steps need at the roofline, the larger of the
model's attention FLOPs over the device's bf16 peak (the family's
``mla_attention_flops``: causal pairs, q.k over nope + rope and p.v over
v's head dim, forward and backward) and the kernels' least bytes over
its memory rate (``mla_attention_bytes``), over the device time of the
forward, dQ and dK/dV kernels at (192, 128) in
``rec["trace"]["device_ops"]``. None when the family counts no MLA
attention, or when any of the three kernels is not among the trace's
operations (its top ten)."""
import json
import os
import re

from bench import common, flops

KERNELS = re.compile(r"(flash_tc_kernel|flash_bwd_dq_kernel|"
                     r"flash_bwd_dkv_kernel)<192, ?128>")


def traced_steps(cfg: dict):
    """Steps in the traced stretch: the ``trace_steps`` of the traffic mix
    of the configuration's cells (None unless they agree)."""
    found = set()
    d = os.path.join(common.BENCH, "workloads")
    for f in sorted(os.listdir(d)):
        with open(os.path.join(d, f)) as fh:
            wl = json.load(fh)
        if wl.get("config") == cfg["name"]:
            found.add(common.cell_params(wl)[1].get("trace_steps"))
    return found.pop() if len(found) == 1 else None


def read(rec):
    tr, cfg = rec.get("trace"), rec["config"]
    fam = common.family(cfg)
    peak = flops.peak(rec["device"])
    if not tr or not peak or not hasattr(fam, "mla_attention_flops"):
        return None
    times = {}
    for name, t in tr["device_ops"]:
        m = KERNELS.search(name)
        if m:
            times[m[1]] = times.get(m[1], 0.0) + t
    steps = traced_steps(cfg)
    if len(times) < 3 or not steps:
        return None
    seqs = cfg["rows_per_step"] * steps
    bound = max(fam.mla_attention_flops(cfg) * seqs / peak,
                fam.mla_attention_bytes(cfg) * seqs
                / flops.peak(rec["device"], "hbm_bytes_per_s"))
    return 100.0 * bound / sum(times.values())
