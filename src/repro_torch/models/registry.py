"""Uniform model interface (the dense and ssm families of
``repro.models.registry``).

``build_model(cfg)`` returns a ``Model`` of plain functions:

  init(seed, device)        -> f32 params (a ``torch.Generator`` on
                               ``device`` seeded with ``seed``)
  forward(params, batch)    -> (logits, aux_loss)
  loss(params, batch)       -> scalar (CE + aux)
  init_cache(batch_size, cache_len, device) -> decode cache
  prefill(params, batch, cache)     -> (last-token logits, cache)
  decode(params, tokens, cache, pos) -> (logits, cache)

Prefill and decode are ported for the ssm family only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.models import mamba2, transformer

_FAMILIES = {"dense": transformer, "ssm": mamba2}
#: families whose prefill/decode path is ported
_DECODE = ("ssm",)


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
    init_cache: Callable
    prefill: Callable
    decode: Callable


def build_model(cfg, *, dtype=torch.bfloat16,
                use_kernels: bool = False) -> Model:
    """``dtype`` is the compute dtype weights are cast to at use.

    ``use_kernels`` (the reference's ``use_pallas``) routes ``forward``
    and ``loss`` through the hand-written kernels, wired as the
    reference wires its Pallas ones: ``ssd_intra_chunk`` for the ssm
    family, ``flash_attention`` for dense GQA without a window. Prefill and decode run no kernel. On CPU tensors the kernels'
    plain versions run."""
    if cfg.arch_type not in _FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: arch family {cfg.arch_type!r} is not ported yet "
            f"(ROADMAP.md queue A item 6)")
    fam = _FAMILIES[cfg.arch_type]
    kern = {}
    if use_kernels and cfg.arch_type == "ssm":
        from repro_torch.kernels import ops
        kern["ssd_kernel"] = ops.ssd_intra_chunk
    if use_kernels and cfg.arch_type == "dense" \
            and cfg.attn_kind == "gqa" and cfg.window_size is None:
        from repro_torch.kernels import ops

        def _fa(q, k, v, cap=None):
            return ops.flash_attention(q, k, v, causal=True, cap=cap)
        kern["attn_kernel"] = _fa

    def _decode_family():
        if cfg.arch_type not in _DECODE:
            raise NotImplementedError(
                f"{cfg.name}: prefill/decode of the {cfg.arch_type!r} "
                f"family is not ported yet (ROADMAP.md queue A item 6)")

    def init(seed, device):
        dev = torch.device(device)
        gen = (None if dev.type == "meta"
               else torch.Generator(device=dev).manual_seed(int(seed)))
        return fam.init(cfg, gen, dev)

    def forward(params, batch):
        return fam.forward(params, cfg, batch, dtype=dtype, **kern)

    def loss(params, batch):
        logits, aux = forward(params, batch)
        return cross_entropy(logits, batch["labels"]) + aux

    def init_cache(batch_size, cache_len, device):
        _decode_family()
        return fam.init_cache(cfg, batch_size, cache_len, dtype=dtype,
                              device=torch.device(device))

    def prefill(params, batch, cache):
        _decode_family()
        return fam.prefill(params, cfg, batch, cache, dtype=dtype)

    def decode(params, tokens, cache, pos):
        _decode_family()
        return fam.decode_step(params, cfg, tokens, cache, pos, dtype=dtype)

    return Model(cfg, init, forward, loss, init_cache, prefill, decode)
