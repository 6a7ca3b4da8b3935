#!/usr/bin/env python3
"""Device time of a benchmark configuration's train step, by kernel, on
one CUDA card.

    python3 scripts/step_profile.py [--config gpt3_2_7b_tp4]

Builds the cell's trainer as the benchmark does
(``bench/generators/train_ckpt.build``, seed 12345, no save), draws 4
batches, runs them twice to warm up and once under ``torch.profiler``,
twice over: the whole train step, and the forward and backward alone
(each micro-batch's loss and gradient, with neither the f32 sum nor
Adam). Prints one JSON line: for each, the device milliseconds a step
in all and by class (matmul, elementwise, reduce, adam_kernel,
attention_kernels, other)
and the 40 largest kernels. The step less the forward and backward is
the chain from micro-batch gradients to the bf16 weights.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
import tempfile
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

N_BATCHES = 4
#: kernel classes by name, the first that matches
CLASSES = (("matmul", r"nvjet|gemm|xmma|cutlass"),
           ("adam_kernel", r"adam_kernel"),
           ("attention_kernels", r"flash_(tc|tf32|bwd_dq|bwd_dkv)_kernel"),
           ("reduce", r"reduce_kernel"),
           ("elementwise", r"elementwise|[Cc]opy"))


def _class(name: str) -> str:
    return next((c for c, pat in CLASSES if re.search(pat, name)), "other")


def _profile(fn, n_steps: int) -> dict:
    import torch
    fn()
    fn()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    by = defaultdict(float)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            by[e.name()] += e.duration_ns() / 1e6 / n_steps
    if not by:
        raise RuntimeError("the profiler recorded no device time")
    cls = defaultdict(float)
    for n, t in by.items():
        cls[_class(n)] += t
    top = sorted(by.items(), key=lambda kv: -kv[1])[:40]
    return {"total_ms": round(sum(by.values()), 4),
            "by_class_ms": {k: round(v, 4) for k, v in cls.items()},
            "kernels_ms": [(n[:140], round(t, 4)) for n, t in top]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="gpt3_2_7b_tp4")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card: the profile is of the device")
    from bench import common
    from bench.generators import train_ckpt

    cfg = common.load("configs", args.config)
    params = dict(common.load("traffic", "ckpt_overlap"), limits={})
    with tempfile.TemporaryDirectory(prefix="step-profile-") as d:
        ctx = common.Ctx(config=cfg, params=params, seed=12345, seconds=1,
                         trace=False, device="cuda:0", ckpt_dir=d)
        trainer, _ = train_ckpt.build(ctx, "fastpersist", {})
        out = _run(trainer, cfg, args.config)
        trainer.engine.close()
    print(json.dumps(out))
    return 0


def _run(trainer, cfg: dict, name: str) -> dict:
    import torch
    from repro_torch.tree import leaves
    gas = cfg["rows_per_step"] // cfg["micro_batch"]
    batches = [next(trainer.data) for _ in range(N_BATCHES)]

    def steps():
        for b in batches:
            trainer.state, _ = trainer.train_step(trainer.state, b)
        torch.cuda.synchronize()

    def forward_backward():
        ps = leaves(trainer.state.params)
        for p in ps:
            p.requires_grad_(True)
        for b in batches:
            for mb in range(gas):
                micro = {k: v.reshape(gas, v.shape[0] // gas,
                                      *v.shape[1:])[mb]
                         for k, v in b.items()}
                torch.autograd.grad(trainer.model.loss(
                    trainer.state.params, micro), ps)
        torch.cuda.synchronize()

    return {"config": name, "gas": gas,
            "card": torch.cuda.get_device_name(0),
            "torch": torch.__version__,
            "step": _profile(steps, N_BATCHES),
            "forward_backward": _profile(forward_backward, N_BATCHES)}


if __name__ == "__main__":
    sys.exit(main())
