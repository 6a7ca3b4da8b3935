"""Mamba2 (SSD) decoder-only backbone [arXiv:2405.21060], the
counterpart of ``repro.models.mamba2``.

Layers are stacked on a leading axis, as in the reference; a Python loop
over the layers replaces ``lax.scan``. The decode cache is stacked the
same way: {"conv": (L, B, w-1, conv_dim), "ssm": (L, B, H, P, N)}.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as ly
from repro_torch.models.layers import _ssm_dims


def init(cfg, generator, device):
    """f32 parameters of the reference's tree."""
    L = (cfg.n_layers,)
    return {
        "embed": ly.uniform_scale((cfg.vocab_size, cfg.d_model),
                                  cfg.d_model, generator, device),
        "layers": {"ln": ly.rmsnorm_init(cfg.d_model, device, L),
                   "mixer": ly.mamba2_init(cfg, generator, device, L)},
        "final_norm": ly.rmsnorm_init(cfg.d_model, device),
    }


def _layers(params, cfg, x, cache, ssd_kernel=None):
    """Every layer in turn. cache None (forward, prefill) or the stacked
    decode cache; returns (x, the new stacked cache)."""
    conv, ssm = [], []
    for i, lp in enumerate(ly.layer_slices(params["layers"], cfg.n_layers)):
        c = None if cache is None else {k: v[i] for k, v in cache.items()}
        h = ly.rmsnorm(x, lp["ln"], cfg.norm_eps)
        y, new_c = ly.mamba2_apply(lp["mixer"], h, cfg, cache=c,
                                   ssd_kernel=ssd_kernel)
        x = x + y
        conv.append(new_c["conv"])
        ssm.append(new_c["ssm"])
    return x, {"conv": torch.stack(conv), "ssm": torch.stack(ssm)}


def _logits(params, cfg, x):
    x = ly.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["embed"].T.to(x.dtype)


def forward(params, cfg, batch, *, dtype=torch.bfloat16, moe_groups=1,
            remat=False, ssd_kernel=None):
    """Teacher-forced full-sequence forward. Returns (logits, aux_loss).
    ``moe_groups`` and ``remat`` are unused, as in the reference."""
    x = params["embed"].to(dtype)[batch["tokens"]]
    x, _ = _layers(params, cfg, x, None, ssd_kernel)
    return _logits(params, cfg, x), torch.zeros((), dtype=torch.float32,
                                                device=x.device)


def init_cache(cfg, batch_size: int, cache_len: int, dtype=torch.bfloat16,
               *, device):
    """The zero decode cache on ``device`` (its size does not grow with
    ``cache_len``: the SSM state is O(1) in sequence length)."""
    s = cfg.ssm
    _, nheads, conv_dim = _ssm_dims(cfg)
    L = cfg.n_layers
    return {
        "conv": torch.zeros((L, batch_size, s.conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((L, batch_size, nheads, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
    }


def prefill(params, cfg, batch, cache, *, dtype=torch.bfloat16,
            moe_groups=1):
    """Run the prompt; returns (last-token logits (B, 1, V), the cache).
    Like the reference, the given cache is only a shape: the prompt's
    states replace it."""
    x = params["embed"].to(dtype)[batch["tokens"]]
    x, new_cache = _layers(params, cfg, x, None)
    return _logits(params, cfg, x[:, -1:]), new_cache


def decode_step(params, cfg, tokens, cache, pos, *, dtype=torch.bfloat16,
                moe_groups=1):
    """One token per sequence against the cache. tokens (B, 1); ``pos``
    is unused (the SSM state carries the position)."""
    x = params["embed"].to(dtype)[tokens]
    x, new_cache = _layers(params, cfg, x, cache)
    return _logits(params, cfg, x), new_cache
