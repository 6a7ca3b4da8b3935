"""Uniform model interface (the dense, moe, ssm and hybrid families of
``repro.models.registry``; the dense family with GQA or MLA attention
and gemma2's windows, soft-caps and paired ring cache).

``build_model(cfg)`` returns a ``Model`` of plain functions:

  init(seed, device)        -> f32 params (a ``torch.Generator`` on
                               ``device`` seeded with ``seed``)
  forward(params, batch)    -> (logits, aux_loss)
  loss(params, batch)       -> scalar (CE + aux)
  init_cache(batch_size, cache_len, device) -> decode cache
  prefill(params, batch, cache)     -> (last-token logits, cache)
  decode(params, tokens, cache, pos) -> (logits, cache)

The dense and moe families write into the given KV (or MLA latent)
cache in place and return it; the ssm family returns a new cache; the
hybrid returns a new SSM cache and writes its shared attention's k and
v in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.models import hybrid, mamba2, transformer

_FAMILIES = {"dense": transformer, "moe": transformer, "ssm": mamba2,
             "hybrid": hybrid}
#: families still to port, with their ROADMAP.md queue A item
_NOT_PORTED = {"vlm": "6g", "encdec": "6h"}


def cross_entropy(logits, labels, n_prefix=0, chunk=None):
    """Mean CE over the label positions. logits (B, P+L, V), labels
    (B, L).

    ``chunk``: take the log-softmax over sequence chunks, one at a time,
    to bound the f32 logits alive at once; their mean is the full
    mean."""
    if n_prefix:
        logits = logits[:, n_prefix:]
    L = logits.shape[1]

    def ce(lg, lb):
        lg = lg.float()
        lse = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, lb[..., None].long())[..., 0]
        return lse - gold

    if chunk and L % chunk == 0 and L > chunk:
        return torch.cat([ce(logits[:, i:i + chunk], labels[:, i:i + chunk])
                          for i in range(0, L, chunk)], dim=1).mean()
    return ce(logits, labels).mean()


@dataclass(frozen=True)
class Model:
    cfg: object
    init: Callable
    forward: Callable
    loss: Callable
    init_cache: Callable
    prefill: Callable
    decode: Callable


def build_model(cfg, *, dtype=torch.bfloat16, use_kernels: bool = False,
                ce_chunk: int | None = None, moe_groups: int = 1) -> Model:
    """``dtype`` is the compute dtype weights are cast to at use;
    ``ce_chunk`` the loss's sequence chunk; ``moe_groups`` the MoE
    router's token groups, as in the reference.

    ``use_kernels`` (the reference's ``use_pallas``) routes ``forward``
    and ``loss`` through the hand-written kernels, wired as the
    reference wires its Pallas ones: ``ssd_intra_chunk`` for the ssm
    and hybrid families, ``flash_attention`` for dense and moe GQA
    without a window.
    Prefill and decode run no kernel. On CPU tensors the kernels' plain
    versions run."""
    if cfg.arch_type not in _FAMILIES:
        item = _NOT_PORTED.get(cfg.arch_type, "6")
        raise NotImplementedError(
            f"{cfg.name}: arch family {cfg.arch_type!r} is not ported yet "
            f"(ROADMAP.md queue A item {item})")
    fam = _FAMILIES[cfg.arch_type]
    if fam is transformer:
        transformer.check_ported(cfg)
    kern = {}
    if use_kernels and cfg.arch_type in ("ssm", "hybrid"):
        from repro_torch.kernels import ops
        kern["ssd_kernel"] = ops.ssd_intra_chunk
    if use_kernels and cfg.arch_type in ("dense", "moe") \
            and cfg.attn_kind == "gqa" and cfg.window_size is None:
        from repro_torch.kernels import ops

        def _fa(q, k, v, cap=None):
            return ops.flash_attention(q, k, v, causal=True, cap=cap)
        kern["attn_kernel"] = _fa

    def init(seed, device):
        dev = torch.device(device)
        gen = (None if dev.type == "meta"
               else torch.Generator(device=dev).manual_seed(int(seed)))
        return fam.init(cfg, gen, dev)

    def forward(params, batch):
        return fam.forward(params, cfg, batch, dtype=dtype,
                           moe_groups=moe_groups, **kern)

    def loss(params, batch):
        logits, aux = forward(params, batch)
        return cross_entropy(logits, batch["labels"], chunk=ce_chunk) + aux

    def init_cache(batch_size, cache_len, device):
        return fam.init_cache(cfg, batch_size, cache_len, dtype=dtype,
                              device=torch.device(device))

    def prefill(params, batch, cache):
        return fam.prefill(params, cfg, batch, cache, dtype=dtype,
                           moe_groups=moe_groups)

    def decode(params, tokens, cache, pos):
        return fam.decode_step(params, cfg, tokens, cache, pos, dtype=dtype,
                               moe_groups=moe_groups)

    return Model(cfg, init, forward, loss, init_cache, prefill, decode)
