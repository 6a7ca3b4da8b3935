"""Uniform model interface over every family of
``repro.models.registry``: dense and moe (GQA or MLA attention, gemma2's
windows, soft-caps and paired ring cache), vlm (the dense transformer
with a vision prefix), ssm, hybrid and encdec.

``build_model(cfg)`` returns a ``Model`` of plain functions:

  init(seed, device)        -> f32 params (a ``torch.Generator`` on
                               ``device`` seeded with ``seed``)
  forward(params, batch)    -> (logits, aux_loss)
  loss(params, batch)       -> scalar (CE + aux)
  init_cache(batch_size, cache_len, device) -> decode cache
  prefill(params, batch, cache)     -> (last-token logits, cache)
  decode(params, tokens, cache, pos) -> (logits, cache)

The dense, moe, vlm and encdec families write into the given KV (or
MLA latent) cache in place and return it (encdec also puts the encoder
output in it); the ssm family returns a new cache; the hybrid returns a
new SSM cache and writes its shared attention's k and v in place.

``make_batch`` is the reference's synthetic batch: the same token and
label ids, and its constant frontend inputs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.data.pipeline import prng_key, randint, split
from repro_torch.models import encdec, hybrid, mamba2, transformer

_FAMILIES = {"dense": transformer, "moe": transformer, "vlm": transformer,
             "ssm": mamba2, "hybrid": hybrid, "encdec": encdec}


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
                ce_chunk: int | None = None, moe_groups: int = 1,
                remat: bool = False, mesh=None) -> Model:
    """``dtype`` is the compute dtype weights are cast to at use;
    ``ce_chunk`` the loss's sequence chunk; ``moe_groups`` the MoE
    router's token groups, as in the reference.

    ``use_kernels`` (the reference's ``use_pallas``) routes ``forward``
    and ``loss`` through the hand-written kernels, wired as the
    reference wires its Pallas ones: ``ssd_intra_chunk`` for the ssm
    and hybrid families, ``flash_attention`` for dense, moe and vlm GQA
    without a window.
    Prefill and decode run no kernel, nor does encdec. On CPU tensors
    the kernels' plain versions run.

    ``remat``: ``forward`` and ``loss`` recompute each layer's
    activations in the backward (the dense, moe, vlm stacks and encdec's
    decoder; the ssm and hybrid families take the flag and ignore it, as
    the reference's do). ``mesh``: MoE layers run expert-parallel
    (``sharding/moe_ep.py``): a ``ProcessMesh`` across its ranks, each
    holding its ``local_params``; a ``Mesh`` description on meta tensors
    only (the dry run)."""
    fam = _FAMILIES[cfg.arch_type]
    kern = {}
    if mesh is not None and cfg.moe is not None:
        from repro_torch.sharding.moe_ep import make_moe_ep
        kern["moe_kernel"] = make_moe_ep(mesh)
    if use_kernels and cfg.arch_type in ("ssm", "hybrid"):
        from repro_torch.kernels import ops
        kern["ssd_kernel"] = ops.ssd_intra_chunk
    if use_kernels and cfg.arch_type in ("dense", "moe", "vlm") \
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
                           moe_groups=moe_groups, remat=remat, **kern)

    def loss(params, batch):
        logits, aux = forward(params, batch)
        n_prefix = 0
        if cfg.frontend == "vision" and "patch_embeds" in batch:
            n_prefix = batch["patch_embeds"].shape[1]
        return cross_entropy(logits, batch["labels"], n_prefix,
                             chunk=ce_chunk) + aux

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


def make_batch(cfg, batch_size: int, seq_len: int, seed: int = 0,
               dtype=torch.bfloat16, device="cuda"):
    """The reference's synthetic batch on ``device``: token and label ids
    drawn as ``jax.random`` draws them from ``PRNGKey(seed)`` (so they
    equal the reference's), and the frontends' inputs at 0.01 in
    ``dtype``: ``patch_embeds`` (B, n_frontend_tokens, d_model) for the
    vision frontend, ``audio_frames`` (B, n_enc_ctx, d_model) for
    encdec."""
    k1, k2 = split(prng_key(seed))
    shape = (batch_size, seq_len)
    batch = {name: torch.from_numpy(randint(k, shape, 0, cfg.vocab_size))
             .to(device) for name, k in (("tokens", k1), ("labels", k2))}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = torch.full(
            (batch_size, cfg.n_frontend_tokens, cfg.d_model), 0.01,
            dtype=dtype, device=device)
    if cfg.arch_type == "encdec":
        batch["audio_frames"] = torch.full(
            (batch_size, cfg.n_enc_ctx, cfg.d_model), 0.01, dtype=dtype,
            device=device)
    return batch
