"""Mixed-precision Adam as the configuration states it (global-norm clip,
linear warm-up, bias correction, decoupled weight decay on every leaf),
kept entirely in the master weights' dtype (float32): master weights,
moments and update. The program keeps the same float32 state and copies
the master into bfloat16 weights after each step; here the master is
itself the model's weights.
"""
from __future__ import annotations

import torch


def init(master: dict) -> dict:
    return {"step": 0, "master": master,
            "m": {k: torch.zeros_like(v) for k, v in master.items()},
            "v": {k: torch.zeros_like(v) for k, v in master.items()}}


@torch.no_grad()
def step(opt: dict, grads: dict, hp: dict):
    """One step over flat ``{name: tensor}`` dicts, in place."""
    opt["step"] += 1
    t = float(opt["step"])
    gnorm = torch.sqrt(sum(g.double().square().sum() for g in grads.values()))
    scale = min(hp["grad_clip"] / (float(gnorm) + 1e-9), 1.0)
    lr = hp["lr"] * min(t / hp["warmup_steps"], 1.0)
    b1, b2 = hp["b1"], hp["b2"]
    for k, g in grads.items():
        g = g * scale
        m, v, w = opt["m"][k], opt["v"][k], opt["master"][k]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g.square())
        upd = (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + hp["eps"])
        w.sub_(lr * (upd + hp["weight_decay"] * w))
