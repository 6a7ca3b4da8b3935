"""Train and decode steps over the uniform Model API (the counterpart of
``repro.train.steps``)."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import spans
from repro_torch.optim import adam
from repro_torch.optim.adam import AdamConfig, AdamState
from repro_torch.tree import leaves, tree_map


class TrainState(NamedTuple):
    params: Any          # bf16 working copy (2 B/param)
    opt: AdamState       # fp32 master + m + v (12 B/param) ⇒ 14 B total


def init_train_state(model, seed: int, device) -> TrainState:
    """Fresh state from ``model.init`` (``device="meta"`` gives the
    structure without storage, e.g. as a restore template)."""
    params_f32 = model.init(seed, device)
    params = tree_map(lambda p: p.to(torch.bfloat16)
                      if p.dtype == torch.float32 else p, params_f32)
    return TrainState(params, adam.init(params))


def make_train_step(model, opt_cfg: AdamConfig, gas: int = 1):
    """Returns train_step(state, batch) -> (state, metrics). The state is
    updated in place (see :func:`repro_torch.optim.adam.apply_`).

    gas > 1: gradient accumulation — the batch's leading dim is split
    into ``gas`` microbatches run sequentially (paper §2.1.2)."""

    def step(state: TrainState, batch):
        ps = leaves(state.params)
        for p in ps:
            p.requires_grad_(True)
        if gas == 1:
            loss = model.loss(state.params, batch)
            grads = torch.autograd.grad(loss, ps)
        else:
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in ps]
            loss = 0.0
            for mb in range(gas):
                micro = {k: v.reshape(gas, v.shape[0] // gas,
                                      *v.shape[1:])[mb]
                         for k, v in batch.items()}
                lm = model.loss(state.params, micro)
                for acc, g in zip(grads, torch.autograd.grad(lm, ps)):
                    acc.add_(g.float())
                loss = loss + lm.detach()
            grads = [g / gas for g in grads]
            loss = loss / gas
        with spans.span("train.adam"):
            adam.apply_(opt_cfg, grads, state.params, state.opt)
        metrics = {"loss": loss.detach().float(), "step": state.opt.step}
        return state, metrics

    def train_step(state: TrainState, batch):
        with spans.span("train.step"):
            return step(state, batch)

    return train_step


def make_decode_step(model):
    """Returns decode_step(params, tokens, cache, pos) -> (next greedy
    token (B, 1) int32, cache)."""
    def decode_step(params, tokens, cache, pos):
        logits, cache = model.decode(params, tokens, cache, pos)
        next_tok = logits[:, -1:].argmax(dim=-1).to(torch.int32)
        return next_tok, cache
    return decode_step
