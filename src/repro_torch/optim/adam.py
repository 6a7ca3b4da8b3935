"""Mixed-precision Adam (paper §2.1.3), the counterpart of
``repro.optim.adam``.

State per parameter: bf16 model copy (what forward/backward consume) plus
fp32 master weights, first and second moments ⇒ 2+4+4+4 = 14 bytes per
parameter. Same arithmetic as the reference: global-norm clip, linear
warmup, bias correction, decoupled weight decay on the fp32 master, and
a bf16 copy back into the parameters.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.tree import leaves, tree_map


@dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


class AdamState(NamedTuple):
    step: torch.Tensor      # int32, shape ()
    master: Any             # fp32 master weights (pytree)
    m: Any                  # fp32 first moment
    v: Any                  # fp32 second moment


def init(params_bf16) -> AdamState:
    master = tree_map(lambda p: p.detach().float().clone(), params_bf16)
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    device = leaves(params_bf16)[0].device
    return AdamState(torch.zeros((), dtype=torch.int32, device=device),
                     master, tree_map(zeros, master), tree_map(zeros, master))


@torch.no_grad()
def apply_(cfg: AdamConfig, grads, params, state: AdamState):
    """One Adam step, IN PLACE: ``state`` (step, master, m, v) and the
    bf16 ``params`` are updated leaf by leaf under ``torch.no_grad()``.
    Updating in place saves the second copy of the 14 B/param state that
    JAX's functional update avoided with buffer donation; it is also why
    the trainer must wait for the previous checkpoint's snapshot before
    it calls this (the §4.3 sync point). ``grads`` is a list in the
    order of ``leaves(params)``."""
    state.step.add_(1)
    step = state.step.float()
    gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = cfg.lr * torch.clamp(step / cfg.warmup_steps, max=1.0)
    b1c = 1 - cfg.b1 ** step
    b2c = 1 - cfg.b2 ** step
    for g, p, mw, m, v in zip(grads, leaves(params),
                              leaves(state.master),
                              leaves(state.m), leaves(state.v)):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
        update = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        mw.sub_(lr * (update + cfg.weight_decay * mw))
        p.copy_(mw)
