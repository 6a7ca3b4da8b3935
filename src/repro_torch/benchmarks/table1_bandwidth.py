"""Paper Table 1 + Eq. 1/Eq. 2: required overlap bandwidth B_C for each
GPT-3 config at max DP, and recovery-cost analysis (the counterpart of
``benchmarks/table1_bandwidth.py``). Analytic: the iteration time comes
from the §3.2 estimator at the peak of the PAPER's V100s, since the
table describes the paper's cluster; ``device`` is checked only."""
from repro_torch.benchmarks.common import emit, resolve_device
from repro_torch.benchmarks.fig9_dense_models import PAPER_V100_FP16_FLOPS
from repro_torch.configs import PAPER_TABLE2, get_paper_config
from repro_torch.core.overlap import (estimate_iteration,
                                      recovery_overhead_gpu_seconds,
                                      required_bandwidth)

# (model, max DP, nodes) from paper Table 1
ROWS = [("gpt3_0_7b", 256, 16), ("gpt3_1_3b", 512, 64),
        ("gpt3_2_7b", 512, 128), ("gpt3_6_7b", 1024, 512),
        ("gpt3_13b", 1024, 1024)]
#: the paper's node write bandwidth (Table 1: 24.8 GB/s a DGX-2 node)
PAPER_NODE_BPS = 24.8e9


def run(quick=True, device="cuda"):
    resolve_device(device)
    out = {}
    for key, dp, nodes in ROWS:
        cfg = get_paper_config(key)
        gbs = PAPER_TABLE2[key]["gbs"]
        n_gpus = dp * PAPER_TABLE2[key]["mp"]
        it = estimate_iteration(cfg, gbs, 2048, n_gpus,
                                peak_flops=PAPER_V100_FP16_FLOPS, mfu=0.4)
        bc = required_bandwidth(cfg.checkpoint_bytes(), it)
        avail = nodes * PAPER_NODE_BPS
        out[key] = bc
        emit(f"table1/{key}_Bc", it.fb,
             f"{bc/1e9:.0f}GBps_avail{avail/1e9:.0f}GBps_"
             f"{'OK' if bc < avail else 'INSUFFICIENT'}")

        # Eq. 2 recovery: n=100 vs n=1 checkpoint interval
        for n in (100, 1):
            r = recovery_overhead_gpu_seconds(n, n_gpus, it.total)
            emit(f"eq2/{key}_interval{n}", it.total,
                 f"{r/3600:.1f}GPUh_lost_per_failure")
    return out


if __name__ == "__main__":
    run()
