"""Fixtures of the benchmark's CPU tests: a tiny configuration of the
same shape as the cells' and a run context on the CPU."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {
    "name": "tiny", "source": "tiny test shape",
    "n_layers": 1, "d_model": 64, "n_heads": 2, "head_dim": 32,
    "d_ff": 256, "vocab_size": 96, "seq_len": 16, "gated_mlp": False,
    "norm_eps": 1e-5, "rope_theta": 10000.0,
    "rows_per_step": 8, "micro_batch": 2,
    "optimizer": {"lr": 2.0e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
                  "weight_decay": 0.1, "grad_clip": 1.0,
                  "warmup_steps": 358},
}

TRAIN = {"backend": "fastpersist-pipelined", "keep_last": 1,
         "warm_steps": 3, "saves": 2, "trace_steps": 4,
         "limits": {"loss_gap": 0.01, "grad_gap": 0.05, "delta_gap": 0.05,
                    "saved_mismatch": 0}}


@pytest.fixture
def make_ctx(tmp_path):
    from bench import common

    def make(params, seconds=0.5, seed=2 ** 31 + 7, trace=False, cfg=None):
        d = tmp_path / f"ckpt{seed}"
        d.mkdir()
        return common.Ctx(config=dict(cfg or TINY),
                          params=dict(params), seed=seed, seconds=seconds,
                          trace=trace, device="cpu", ckpt_dir=str(d))
    return make
