"""The reference of the ``gpt`` family: the configuration's one-chip
share of a GPT decoder, in float32, for the loss and its gradient
(through autograd, plain PyTorch).

It computes what the program's dense decoder computes, which departs from
the published GPT-3 in three places that the program inherits from its
own reference package: RMSNorm in place of LayerNorm, rotary positions
(theta from the configuration) in place of learned ones, and a two-matrix
MLP under SiLU in place of GELU; no biases, and the output head tied to
the embedding. The attention share holds the configuration's heads, the
vocabulary share its rows: the loss is over that slice.

Where it departs from the program's arithmetic, on purpose: every value
and product is float32 with TF32 off, where the program casts weights and
activations to bfloat16 and keeps norms, rotary, scores and the loss in
float32; the weights are the float32 master weights, where the program
reads their bfloat16 copy. Every value takes the weights' dtype, so the
same code in bfloat16 is the control of the training numbers.
"""
from __future__ import annotations

import math

import torch


def rmsnorm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rotary(x, pos, theta):
    """x (B, L, H, hd): rotate-half pairs of the two halves of hd."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    ang = pos.float()[:, None] * freqs
    c = torch.cos(ang)[:, None, :].to(x.dtype)
    s = torch.sin(ang)[:, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def block(cfg, x, p, i, pos):
    B, L, _ = x.shape
    H, hd = cfg["n_heads"], cfg["head_dim"]
    a = p["layers"]["attn"]
    h = rmsnorm(x, p["layers"]["ln1"][i], cfg["norm_eps"])
    q = (h @ a["wq"][i]).reshape(B, L, H, hd)
    k = (h @ a["wk"][i]).reshape(B, L, H, hd)
    v = (h @ a["wv"][i]).reshape(B, L, H, hd)
    q, k = rotary(q, pos, cfg["rope_theta"]), rotary(k, pos, cfg["rope_theta"])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    causal = pos[:, None] >= pos[None, :]
    s = s.masked_fill(~causal, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    x = x + o.reshape(B, L, H * hd) @ a["wo"][i]
    m = p["layers"]["mlp"]
    h = rmsnorm(x, p["layers"]["ln2"][i], cfg["norm_eps"])
    return x + torch.nn.functional.silu(h @ m["wi"][i]) @ m["wo"][i]


def loss(cfg, p, tokens, labels):
    """Mean cross-entropy over every label of the rows."""
    x = p["embed"][tokens.long()]
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    for i in range(cfg["n_layers"]):
        x = block(cfg, x, p, i, pos)
    x = rmsnorm(x, p["final_norm"], cfg["norm_eps"])
    logits = x @ p["embed"].T
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long())
