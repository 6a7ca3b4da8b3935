"""Uniform model interface (the dense family of
``repro.models.registry``).

``build_model(cfg)`` returns a ``Model`` of plain functions:

  init(seed, device)        -> f32 params (a ``torch.Generator`` on
                               ``device`` seeded with ``seed``)
  forward(params, batch)    -> (logits, aux_loss)
  loss(params, batch)       -> scalar (CE + aux)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.models import transformer

_FAMILIES = {"dense": transformer}


def cross_entropy(logits, labels, n_prefix=0):
    """Mean CE over the label positions. logits (B, P+L, V), labels
    (B, L)."""
    if n_prefix:
        logits = logits[:, n_prefix:]
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (lse - gold).mean()


@dataclass(frozen=True)
class Model:
    cfg: object
    init: Callable
    forward: Callable
    loss: Callable


def build_model(cfg, *, dtype=torch.bfloat16) -> Model:
    """``dtype`` is the compute dtype weights are cast to at use."""
    if cfg.arch_type not in _FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: arch family {cfg.arch_type!r} is not ported yet "
            f"(ROADMAP.md queue A item 6)")
    fam = _FAMILIES[cfg.arch_type]

    def init(seed, device):
        dev = torch.device(device)
        gen = (None if dev.type == "meta"
               else torch.Generator(device=dev).manual_seed(int(seed)))
        return fam.init(cfg, gen, dev)

    def forward(params, batch):
        return fam.forward(params, cfg, batch, dtype=dtype)

    def loss(params, batch):
        logits, aux = forward(params, batch)
        return cross_entropy(logits, batch["labels"]) + aux

    return Model(cfg, init, forward, loss)
