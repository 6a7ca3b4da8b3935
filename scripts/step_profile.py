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
and the 40 largest kernels, and by program span (``by_span_ms``): the
device time of the kernels launched inside each span of
``repro_torch.spans`` (``fwd``) and of the backward nodes of the
operators it ran (``bwd``, matched by autograd sequence number). The
step less the forward and backward is the chain from micro-batch
gradients to the bf16 weights.
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
CLASSES = (("grouped_matmul", r"GroupProblemShape|[Gg]rouped"),
           ("matmul", r"nvjet|gemm|xmma|cutlass"),
           ("adam_kernel", r"adam_kernel"),
           ("attention_kernels", r"flash_(tc|tf32|bwd_dq|bwd_dkv)_kernel"),
           ("reduce", r"reduce_kernel"),
           ("elementwise", r"elementwise|[Cc]opy"))


def _class(name: str) -> str:
    return next((c for c, pat in CLASSES if re.search(pat, name)), "other")


def _annotated_spans():
    """``repro_torch.spans.span`` made to open a profiler range of its
    name as well; returns the original, to put back."""
    import contextlib
    import torch
    from repro_torch import spans
    real = spans.span

    @contextlib.contextmanager
    def span(name, nbytes=0):
        with torch.profiler.record_function(name), real(name, nbytes) as sp:
            yield sp
    spans.span = span
    return real


_NODE = re.compile(r"Backward\d+$")


def _ancestor(e, pred):
    while e is not None and not pred(e):
        e = e.cpu_parent
    return e


def by_span(events, names, time=lambda e: e.device_time_total) -> dict:
    """{span: {"fwd": t, "bwd": t}} over profiler ``events``: ``fwd`` the
    ``time`` of each range named after a span; ``bwd`` that of the
    backward nodes (``...Backward<n>``) that an operator inside such a
    range made, the innermost such range. An operator records the
    sequence number the next node takes, so a node's maker is the last
    forward operator that recorded its number."""
    out, owner, nodes = {}, {}, []
    for e in events:
        if e.name in names:
            out.setdefault(e.name, {"fwd": 0.0, "bwd": 0.0})
            out[e.name]["fwd"] += time(e)
        if _NODE.search(e.name):
            if not e.name.startswith("autograd::"):
                nodes.append(e)
            continue
        if e.sequence_nr < 0 or _ancestor(
                e, lambda a: _NODE.search(a.name)) is not None:
            continue
        span = _ancestor(e, lambda a: a.name in names)
        t0 = e.time_range.start
        if e.sequence_nr not in owner or t0 >= owner[e.sequence_nr][0]:
            owner[e.sequence_nr] = (t0, span.name if span else None)
    for e in nodes:
        n = owner.get(e.sequence_nr, (0, None))[1]
        if n is not None:
            out[n]["bwd"] += time(e)
    return out


def _profile(fn, n_steps: int) -> dict:
    import torch
    from repro_torch.spans import __doc__ as doc
    names = set(re.findall(r"``([a-z_]+\.[a-z_0-9.]+)``", doc))
    fn()
    fn()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    real = _annotated_spans()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            fn()
    finally:
        from repro_torch import spans
        spans.span = real
    by = defaultdict(float)
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == torch.autograd.DeviceType.CUDA
                and e.name() not in names):
            by[e.name()] += e.duration_ns() / 1e6 / n_steps
    if not by:
        raise RuntimeError("the profiler recorded no device time")
    cls = defaultdict(float)
    for n, t in by.items():
        cls[_class(n)] += t
    top = sorted(by.items(), key=lambda kv: -kv[1])[:40]
    spans_ms = {n: {k: round(v / 1e3 / n_steps, 4) for k, v in d.items()}
                for n, d in by_span(prof.events(), names).items()}
    return {"total_ms": round(sum(by.values()), 4),
            "by_class_ms": {k: round(v, 4) for k, v in cls.items()},
            "by_span_ms": spans_ms,
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
