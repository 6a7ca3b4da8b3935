"""The reference of the ``deepseek_v2`` family: one chip's share of
DeepSeek-V2's decoder, in float32 (TF32 off, ``train.no_tf32``), for the
loss (cross-entropy plus the balance loss) and its gradient through
autograd, in plain PyTorch.

What it computes, after DeepSeek-V2's released modelling code and
config: multi-head latent attention, without a query LoRA (q = x W_q; k
and v from the normalised latent of x W_kv_a times W_kv_b; the rotary
part of k from x W_kv_a, shared by the heads), causal, its rotary
dims under the config's YaRN scaling and its scores scaled by
mscale(``mscale_all_dim``)^2 / sqrt(nope + rope); the leading dense layers' SwiGLU of
``intermediate_size``; in each MoE layer, s = softmax(x W_r) over all
``router_experts``, the top ``num_experts_per_tok`` of s, gates s at
the top k (``norm_topk_prob`` false, ``routed_scaling_factor`` 1, the
only values the family takes), each held expert's SwiGLU on the tokens
routed to it by a loop over the held experts, and the shared experts'
SwiGLU on every token; RMSNorm before each part and at the end; an untied head. The
balance loss per sequence b: f_{b,i} = E / (K S) times the pairs routed
to expert i, P_{b,i} the mean of s_{t,i} over b's tokens, alpha times
the mean over b of sum_i f_{b,i} P_{b,i}, summed over the MoE layers.
Only the held experts' part of each MoE layer goes on, as on one rank of
expert parallelism.

Departures from the published description: rotate-half pairs of the
rotary dims where the released code interleaves them (a fixed
permutation of those dims of W_q and W_kv_a). The top k is taken from a
stable descending sort (ties to the lower index).

To fit at the cell's depth it is computed in blocks without a change to
its arithmetic: each layer under ``torch.utils.checkpoint``, the
attention scores one sequence at a time, and the head and the loss one
sequence at a time under ``checkpoint``. Every value takes the weights'
dtype, so the same code in bfloat16 is the control of the training
numbers.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference.gpt import rmsnorm


def _slices(tree: dict, n: int) -> list:
    """The ``n`` layers of a stacked subtree, one ``unbind`` a leaf."""
    split = {k: _slices(v, n) if isinstance(v, dict) else torch.unbind(v)
             for k, v in tree.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


def swiglu(x, w):
    """down(silu(x gate) * (x up)): ``wg`` the gate, ``wi`` the up
    projection, ``wo`` the down projection."""
    return (F.silu(x @ w["wg"]) * (x @ w["wi"])) @ w["wo"]


def _mscale(factor, mscale):
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn(cfg, pos):
    """cos and sin (S, rope // 2) of the rotary dims and the scores' scale,
    as the released code's ``DeepseekV2YarnRotaryEmbedding`` and its
    attention compute them from ``rope_scaling``."""
    y, dim = cfg["rope_scaling"], cfg["qk_rope_head_dim"]
    base, factor = cfg["rope_theta"], y["factor"]

    def correction(rotations):
        return (dim * math.log(y["original_max_position_embeddings"]
                               / (rotations * 2 * math.pi))
                / (2 * math.log(base)))
    low = max(math.floor(correction(y["beta_fast"])), 0)
    high = min(math.ceil(correction(y["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    even = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=pos.device) / dim
    extra = 1.0 / base ** even
    inter = 1.0 / (factor * base ** even)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=pos.device)
             - low) / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp
    ang = torch.outer(pos.float(), inter * (1 - keep) + extra * keep)
    m = _mscale(factor, y["mscale"]) / _mscale(factor, y["mscale_all_dim"])
    scale = (cfg["qk_nope_head_dim"] + dim) ** -0.5
    if y["mscale_all_dim"]:
        scale = scale * _mscale(factor, y["mscale_all_dim"]) ** 2
    return torch.cos(ang) * m, torch.sin(ang) * m, scale


def rotate(x, cos, sin):
    """x (B, S, H, rope): rotate-half pairs of the two halves."""
    half = x.shape[-1] // 2
    c = cos[:, None, :].to(x.dtype)
    s = sin[:, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(cfg, a, h, pos):
    B, S, _ = h.shape
    H = cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    vd, r = cfg["v_head_dim"], cfg["kv_lora_rank"]
    cos, sin, scale = yarn(cfg, pos)
    q = (h @ a["wq"]).reshape(B, S, H, nope + rope)
    q = torch.cat([q[..., :nope], rotate(q[..., nope:], cos, sin)], -1)
    kv_a = h @ a["wkv_a"]
    latent = rmsnorm(kv_a[..., :r], a["kv_norm"], cfg["rms_norm_eps"])
    k_rope = rotate(kv_a[..., r:].reshape(B, S, 1, rope), cos, sin)
    kv = (latent @ a["wkv_b"]).reshape(B, S, H, nope + vd)
    k = torch.cat([kv[..., :nope], k_rope.expand(B, S, H, rope)], -1)
    v = kv[..., nope:]
    causal = pos[:, None] >= pos[None, :]
    outs = []
    for b in range(B):
        s = torch.einsum("qhd,khd->hqk", q[b], k[b]) * scale
        s = s.masked_fill(~causal, float("-inf"))
        outs.append(torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v[b]))
    return torch.stack(outs).reshape(B, S, H * vd) @ a["wo"]


def dense_block(cfg, x, lp, pos):
    eps = cfg["rms_norm_eps"]
    x = x + attention(cfg, lp["attn"], rmsnorm(x, lp["ln1"], eps), pos)
    return x + swiglu(rmsnorm(x, lp["ln2"], eps), lp["mlp"])


def moe(cfg, m, h):
    """The MoE part of one layer on h (B, S, d): (held experts' part plus
    the shared experts', the balance loss)."""
    B, S, d = h.shape
    E, K = cfg["router_experts"], cfg["num_experts_per_tok"]
    x = h.reshape(B * S, d)
    s = torch.softmax(x @ m["router"], -1)
    top = torch.sort(s.detach(), dim=-1, descending=True,
                     stable=True).indices
    top = top[:, :K]
    gate = s.gather(-1, top)
    routed = torch.zeros_like(x)
    e0 = cfg["first_held_expert"]
    for j in range(cfg["n_routed_experts"]):
        tok, kk = torch.nonzero(top == e0 + j, as_tuple=True)
        w = {n: m[n][j] for n in ("wi", "wg", "wo")}
        routed = routed.index_add(
            0, tok, swiglu(x[tok], w) * gate[tok, kk][:, None])
    out = routed.reshape(B, S, d)
    if cfg["n_shared_experts"]:
        out = out + swiglu(h, m["shared"])
    P = s.reshape(B, S, E)
    idx = top.reshape(B, S * K)
    f = torch.zeros((B, E), dtype=s.dtype, device=s.device).scatter_add(
        1, idx, torch.ones(idx.shape, dtype=s.dtype, device=s.device))
    f = f * (E / (K * S))
    aux = cfg["aux_loss_alpha"] * (f * P.mean(1)).sum(1).mean()
    return out, aux


def moe_block(cfg, x, lp, pos):
    eps = cfg["rms_norm_eps"]
    x = x + attention(cfg, lp["attn"], rmsnorm(x, lp["ln1"], eps), pos)
    out, aux = moe(cfg, lp["mlp"], rmsnorm(x, lp["ln2"], eps))
    return x + out, aux


def _row_ce(x, w, labels):
    return F.cross_entropy(x @ w, labels.long(), reduction="sum")


def loss(cfg, p, tokens, labels):
    """Mean cross-entropy over every label of the rows, plus the MoE
    layers' balance losses."""
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device)
    x = p["embed"][tokens.long()]
    Ld = cfg["first_k_dense_replace"]
    if Ld:
        for lp in _slices(p["dense_layers"], Ld):
            x = checkpoint(dense_block, cfg, x, lp, pos, use_reentrant=False)
    aux = 0.0
    for lp in _slices(p["layers"], cfg["n_layers"] - Ld):
        x, a = checkpoint(moe_block, cfg, x, lp, pos, use_reentrant=False)
        aux = aux + a
    x = rmsnorm(x, p["final_norm"], cfg["rms_norm_eps"])
    ce = sum(checkpoint(_row_ce, x[b], p["lm_head"], labels[b],
                        use_reentrant=False) for b in range(B))
    return ce / (B * S) + aux
