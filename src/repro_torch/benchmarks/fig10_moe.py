"""Paper Fig. 10: sparse (MoE) checkpointing — gpt3-1.8B-MoE, EP=16 (the
counterpart of ``benchmarks/fig10_moe.py``). Sparse models checkpoint
~4x the bytes of their dense compute twin, so FastPersist's win is
larger at equal DP (paper §5.5).

fig10a saves a state drawn on ``device`` (the paper's checkpoint over
SCALE, cut further at low DP) through the baseline and FastPersist;
fig10b projects the end-to-end speedup on the paper's cluster, from the
§3.2 estimator at the peak of the PAPER's V100s."""
import os
import shutil

from repro_torch.benchmarks.common import (bench_dir, cleanup, emit,
                                           resolve_device, sync,
                                           synth_state)
from repro_torch.benchmarks.fig9_dense_models import PAPER_V100_FP16_FLOPS
from repro_torch.configs import PAPER_TABLE2, get_paper_config
from repro_torch.core.baseline import BaselineCheckpointer
from repro_torch.core.checkpointer import (FastPersistCheckpointer,
                                           FastPersistConfig)
from repro_torch.core.overlap import effective_overhead, estimate_iteration
from repro_torch.core.partition import (Topology, predict_write_seconds,
                                        select_writers)

SCALE = 64
#: the paper's baseline write rate for this figure (§5.5: ~4 GB/s)
PAPER_BASELINE_BPS = 4e9


def ckpt_bytes() -> int:
    """The paper's gpt3-1.8B-MoE checkpoint (Table 2), bytes."""
    return PAPER_TABLE2["gpt3_1_8b_moe"]["ckpt_gb"] * 10**9


def state_elems(dp: int) -> int:
    """Elements of each leaf of fig10a's state at ``dp``: the
    reference's ``synth_state(ck_bytes // SCALE // max(8 // dp, 1))``,
    14 bytes an element."""
    return max(ckpt_bytes() // SCALE // max(8 // dp, 1) // 14, 1)


def run(quick=True, device="cuda"):
    device = resolve_device(device)
    cfg = get_paper_config("gpt3_1_8b_moe")
    meta = PAPER_TABLE2["gpt3_1_8b_moe"]
    ck = ckpt_bytes()
    out = {}
    for dp in ([1, 4, 8] if quick else [1, 2, 4, 8]):
        state = synth_state(0, device, seed=1, n=state_elems(dp))
        sync(device)
        d = os.path.join(bench_dir(), f"f10_{dp}")
        sb = BaselineCheckpointer(os.path.join(d, "bl")).save(state, 0)
        fp = FastPersistCheckpointer(
            os.path.join(d, "fp"),
            FastPersistConfig(strategy="replica",
                              topology=Topology(dp_degree=min(dp * 2, 8),
                                                ranks_per_node=8)))
        sf = fp.save(state, 0)
        shutil.rmtree(d, ignore_errors=True)
        del state
        emit(f"fig10a/moe_dp{dp}_ckpt_speedup", sf.seconds,
             f"{sb.seconds/sf.seconds:.1f}x")

        it = estimate_iteration(cfg, meta["gbs"], 2048, 16 * dp,
                                peak_flops=PAPER_V100_FP16_FLOPS, mfu=0.35)
        # EP=16: one node a replica
        topo = Topology(dp_degree=dp, ranks_per_node=1)
        t_fp = predict_write_seconds(
            topo, ck, select_writers(topo, "replica"))
        t_bl = ck / PAPER_BASELINE_BPS
        e2e = (1 + effective_overhead(it, t_bl, False)) / \
            (1 + effective_overhead(it, t_fp, True))
        out[dp] = e2e
        emit(f"fig10b/moe_dp{dp}_e2e", it.total, f"{e2e:.1f}x_model")
    return out


if __name__ == "__main__":
    run()
    cleanup()
