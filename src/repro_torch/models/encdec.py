"""Whisper-style encoder-decoder backbone [arXiv:2212.04356], the
counterpart of ``repro.models.encdec``.

The mel-spectrogram + conv frontend is stubbed, as in the reference:
``batch["audio_frames"]`` carries precomputed frame embeddings (B,
n_enc_ctx, d_model). RMSNorm replaces LayerNorm and the decoder uses
RoPE instead of learned positions (the reference's own choices).

The encoder's self-attention is non-causal and has no RoPE; each decoder
block runs causal self-attention with RoPE, then cross-attention over
the encoder output (no RoPE on either side; k and v recomputed from the
encoder output on every call, as the reference does), then the MLP with
``ly.mlp``'s default gelu. Layers are stacked on a leading axis
(``enc_layers``: n_enc_layers, ``dec_layers``: n_layers); a Python loop
replaces ``lax.scan``. The decode cache is {"k", "v": (L, B, S, KV, hd),
"enc_out": (B, T, d)}: prefill and decode write k and v IN PLACE
(ROADMAP C.19) and prefill puts its encoder output in it. No kernel runs
here, as in the reference.
"""
from __future__ import annotations

import math
from functools import partial

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as ly


def _enc_layer_init(cfg, generator, device, lead):
    d = cfg.d_model
    return {"ln1": ly.rmsnorm_init(d, device, lead),
            "attn": ly.gqa_init(cfg, generator, device, lead),
            "ln2": ly.rmsnorm_init(d, device, lead),
            "mlp": ly.mlp_init(d, cfg.d_ff, generator, device,
                               cfg.gated_mlp, lead)}


def _dec_layer_init(cfg, generator, device, lead):
    d = cfg.d_model
    return {"ln1": ly.rmsnorm_init(d, device, lead),
            "self_attn": ly.gqa_init(cfg, generator, device, lead),
            "ln_x": ly.rmsnorm_init(d, device, lead),
            "cross_attn": ly.gqa_init(cfg, generator, device, lead),
            "ln2": ly.rmsnorm_init(d, device, lead),
            "mlp": ly.mlp_init(d, cfg.d_ff, generator, device,
                               cfg.gated_mlp, lead)}


def init(cfg, generator, device):
    """f32 parameters of the reference's tree."""
    d = cfg.d_model
    return {
        "embed": ly.uniform_scale((cfg.vocab_size, d), d, generator,
                                  device),
        "enc_layers": _enc_layer_init(cfg, generator, device,
                                      (cfg.n_enc_layers,)),
        "dec_layers": _dec_layer_init(cfg, generator, device,
                                      (cfg.n_layers,)),
        "enc_norm": ly.rmsnorm_init(d, device),
        "final_norm": ly.rmsnorm_init(d, device),
    }


def _sinusoid(n, d, dtype, device):
    """Positions 0..n-1 in f32, the sin half then the cos half (not
    interleaved), cast to ``dtype``."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos * torch.exp(-dim * math.log(10000.0) / (d // 2))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def encode(params, cfg, frames):
    """frames (B, T, d), the stubbed frontend's output, in the compute
    dtype; returns the encoder output after ``enc_norm``."""
    T = frames.shape[1]
    x = frames + _sinusoid(T, cfg.d_model, frames.dtype, frames.device)
    pos = torch.arange(T, device=frames.device)
    for i in range(cfg.n_enc_layers):
        lp = ly.layer_slice(params["enc_layers"], i)
        h = ly.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = ly.gqa_qkv(lp["attn"], h, cfg)
        o = ly.attention(q, k, v, q_pos=pos, kv_pos=pos, causal=False)
        x = x + ly.gqa_out(lp["attn"], o)
        h = ly.rmsnorm(x, lp["ln2"], cfg.norm_eps)
        x = x + ly.mlp(lp["mlp"], h, gated=cfg.gated_mlp)
    return ly.rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def _dec_block(cfg, x, lp, enc_out, pos, cache_k=None, cache_v=None,
               cache_pos=None):
    """One decoder block. ``cache_k``/``cache_v`` (B, S, KV, hd): this
    layer's self-attention cache, written in place at ``cache_pos``."""
    hd = cfg.resolved_head_dim
    h = ly.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = ly.gqa_qkv(lp["self_attn"], h, cfg)
    cos, sin = ly.rope_tables(pos, hd, cfg.rope_theta)
    q, k = ly.apply_rope(q, cos, sin), ly.apply_rope(k, cos, sin)
    if cache_k is not None:
        end = cache_pos + x.shape[1]
        cache_k[:, cache_pos:end] = k
        cache_v[:, cache_pos:end] = v
        o = ly.attention(q, cache_k, cache_v, q_pos=pos,
                         kv_pos=torch.arange(cache_k.shape[1],
                                             device=x.device),
                         kv_valid_len=end)
    else:
        o = ly.attention(q, k, v, q_pos=pos, kv_pos=pos)
    x = x + ly.gqa_out(lp["self_attn"], o)

    # queries from the decoder; keys and values from the encoder output
    h = ly.rmsnorm(x, lp["ln_x"], cfg.norm_eps)
    cp = lp["cross_attn"]
    B, Lq = h.shape[:2]
    T = enc_out.shape[1]
    qx = (h @ cp["wq"].to(x.dtype)).reshape(B, Lq, cfg.n_heads, hd)
    kx = (enc_out @ cp["wk"].to(x.dtype)).reshape(B, T, cfg.n_kv_heads, hd)
    vx = (enc_out @ cp["wv"].to(x.dtype)).reshape(B, T, cfg.n_kv_heads, hd)
    ox = ly.attention(qx, kx, vx, q_pos=pos,
                      kv_pos=torch.arange(T, device=x.device), causal=False)
    x = x + ly.gqa_out(cp, ox)

    h = ly.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + ly.mlp(lp["mlp"], h, gated=cfg.gated_mlp)


def _decode_layers(params, cfg, x, enc_out, pos, cache=None,
                   cache_pos=None, remat=False):
    """Every decoder block in turn; returns x after the final norm.
    ``remat``: each block's activations recomputed in the backward
    (``jax.checkpoint`` at the reference's encdec.py:122)."""
    for i in range(cfg.n_layers):
        lp = ly.layer_slice(params["dec_layers"], i)
        kv = {} if cache is None else {"cache_k": cache["k"][i],
                                       "cache_v": cache["v"][i],
                                       "cache_pos": cache_pos}
        if remat:
            x = checkpoint(partial(_dec_block, cfg, **kv), x, lp, enc_out,
                           pos, use_reentrant=False)
        else:
            x = _dec_block(cfg, x, lp, enc_out, pos, **kv)
    return ly.rmsnorm(x, params["final_norm"], cfg.norm_eps)


def _unembed(params, x):
    return x @ params["embed"].T.to(x.dtype)


def forward(params, cfg, batch, *, dtype=torch.bfloat16, moe_groups=1,
            remat=False):
    """Teacher-forced forward over ``batch["tokens"]`` given
    ``batch["audio_frames"]``. Returns (logits, zero aux loss), the
    unembedding tied to the embedding. ``remat`` applies to the decoder
    blocks only, as in the reference."""
    enc_out = encode(params, cfg, batch["audio_frames"].to(dtype))
    x = params["embed"].to(dtype)[batch["tokens"]]
    pos = torch.arange(x.shape[1], device=x.device)
    x = _decode_layers(params, cfg, x, enc_out, pos, remat=remat)
    return (_unembed(params, x),
            torch.zeros((), dtype=torch.float32, device=x.device))


def init_cache(cfg, batch_size: int, cache_len: int, dtype=torch.bfloat16,
               *, device):
    """The zero decode cache on ``device``."""
    kv = (cfg.n_layers, batch_size, cache_len, cfg.n_kv_heads,
          cfg.resolved_head_dim)
    return {"k": torch.zeros(kv, dtype=dtype, device=device),
            "v": torch.zeros(kv, dtype=dtype, device=device),
            "enc_out": torch.zeros((batch_size, cfg.n_enc_ctx, cfg.d_model),
                                   dtype=dtype, device=device)}


def prefill(params, cfg, batch, cache, *, dtype=torch.bfloat16,
            moe_groups=1):
    """Encode the frames and run the prompt, writing its k and v into
    ``cache`` from position 0 and the encoder output into
    ``cache["enc_out"]``; returns (last-token logits (B, 1, V), cache)."""
    enc_out = encode(params, cfg, batch["audio_frames"].to(dtype))
    x = params["embed"].to(dtype)[batch["tokens"]]
    pos = torch.arange(x.shape[1], device=x.device)
    x = _decode_layers(params, cfg, x, enc_out, pos, cache, 0)
    cache["enc_out"] = enc_out
    return _unembed(params, x[:, -1:]), cache


def decode_step(params, cfg, tokens, cache, pos, *, dtype=torch.bfloat16,
                moe_groups=1):
    """One token per sequence against the cache. tokens (B, 1); ``pos``
    is the number of tokens already in the cache. Returns (logits (B, 1,
    V), the cache)."""
    pos = int(pos)
    x = params["embed"].to(dtype)[tokens]
    qpos = pos + torch.arange(x.shape[1], device=x.device)
    enc_out = cache["enc_out"].to(dtype)
    x = _decode_layers(params, cfg, x, enc_out, qpos, cache, pos)
    return _unembed(params, x), cache
