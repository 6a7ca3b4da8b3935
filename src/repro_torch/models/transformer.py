"""Decoder-only transformer for the dense and moe families, with GQA or
MLA attention and gemma2's local/global windows, soft-caps, post-norms
and paired ring cache, and the vlm family's vision prefix (the
counterpart of ``repro.models.transformer``).

Layers are stacked on a leading axis, as in the reference; a Python loop
over the layers replaces ``lax.scan``. The decode cache is stacked the
same way: {"k": (L, B, S, KV, hd), "v": ...}; MLA's {"latent": (L, B, S,
kv_lora_rank + rope_dim)}; gemma2's pair layout {"k_loc"/"v_loc": (L/2,
B, min(S, W), KV, hd) rings of its local layers, "k"/"v": (L/2, B, S,
KV, hd) of its global ones}. Prefill and decode write into the given
cache IN PLACE and return it (the reference returns a new cache; its
serving loop donates the old one, so XLA does the same). The
``attn_kernel`` hook takes the flash-attention kernel
(``build_model(use_kernels=True)``); without it, a cacheless causal
attention in bf16 on the card, with no window and no soft-cap, takes the
same kernel and its backward (the train step's attention), and every
other case the plain ``ly.attention``. ``moe_kernel(p, h, cfg)`` replaces
the MoE layer, as in the reference (``sharding/moe_ep.py`` passes its
expert-parallel layer). ``forward(remat=True)`` recomputes each block in
the backward (``torch.utils.checkpoint``), where the reference applies
``jax.checkpoint`` to its scan body (transformer.py:165).
"""
from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers as ly

#: the window of a global layer: unbounded, as the reference's 2**30
GLOBAL_WINDOW = 2 ** 30


def n_dense_layers(cfg) -> int:
    """Leading dense layers of a MoE model (``first_k_dense_replace``),
    kept in a stack of their own, ``dense_layers``, ahead of ``layers``."""
    return getattr(cfg.moe, "first_k_dense_replace", 0)


def _stack_init(cfg, generator, device, n: int, moe: bool):
    L = (n,)
    d = cfg.d_model
    layer = {"ln1": ly.rmsnorm_init(d, device, L),
             "ln2": ly.rmsnorm_init(d, device, L)}
    if cfg.attn_kind == "mla":
        layer["attn"] = ly.mla_init(cfg, generator, device, L)
    else:
        layer["attn"] = ly.gqa_init(cfg, generator, device, L)
    if moe:
        layer["mlp"] = ly.moe_init(cfg, generator, device, L)
    else:
        layer["mlp"] = ly.mlp_init(d, cfg.d_ff, generator, device,
                                   cfg.gated_mlp, L)
    if cfg.attn_softcap is not None:          # gemma2's post-norms
        layer["ln1b"] = ly.rmsnorm_init(d, device, L)
        layer["ln2b"] = ly.rmsnorm_init(d, device, L)
    return layer


def init(cfg, generator, device):
    """f32 parameters of the reference's tree (``layers`` stacked on a
    leading ``n_layers`` axis; a MoE layer's experts stacked (L, E, ...);
    the vision frontend's ``vis_proj``). A MoE model's leading dense
    layers (``n_dense_layers``) are the stack ``dense_layers``, and
    ``layers`` the ``n_layers`` less them that follow."""
    d = cfg.d_model
    n_dense = n_dense_layers(cfg)
    params = {}
    if n_dense:
        params["dense_layers"] = _stack_init(cfg, generator, device,
                                             n_dense, False)
    params["layers"] = _stack_init(cfg, generator, device,
                                   cfg.n_layers - n_dense,
                                   cfg.moe is not None)
    params["embed"] = ly.uniform_scale((cfg.vocab_size, d), d, generator,
                                       device)
    params["final_norm"] = ly.rmsnorm_init(d, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = ly.dense_init(d, cfg.vocab_size, generator,
                                          device)
    if cfg.frontend == "vision":
        params["vis_proj"] = ly.dense_init(d, d, generator, device)
    return params


def _is_global(cfg):
    """Per layer: whether it attends globally (not through the window)."""
    g = cfg.global_every
    return [not g or i % g == g - 1 for i in range(cfg.n_layers)]


def _block(cfg, x, lp, pos, *, is_glob=True, cache_k=None, cache_v=None,
           cache_pos=None, moe_groups=1, attn_kernel=None, moe_kernel=None,
           moe_layer=0):
    """One decoder block; returns (x, aux). ``cache_k``/``cache_v`` (B, S,
    KV, hd): this layer's cache, written in place at ``cache_pos`` (MLA:
    ``cache_k`` is its latent cache). A windowed config gives a local
    layer (``is_glob`` false) its window and a global one 2**30.
    ``attn_kernel(q, k, v, cap=...)`` on (B, H, L, hd) tensors replaces
    the attention under the reference's gate: no cache and no window.
    Without it, ``fa.flash_attention`` (forward and backward kernels)
    takes a cacheless attention where ``fa.kernel_takes`` (bf16 on the
    card, no window, no soft-cap); anything else is ``ly.attention``.
    ``moe_layer``: the block's index among the MoE layers."""
    h = ly.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    if cfg.attn_kind == "mla":
        attn_out, _ = ly.mla_attention(
            lp["attn"], h, cfg, pos, cache=cache_k, cache_pos=cache_pos,
            absorb=cfg.mla_absorb and cache_k is not None,
            attn=partial(_mla_train_attention, pos=pos))
    else:
        q, k, v = ly.gqa_qkv(lp["attn"], h, cfg)
        cos, sin = ly.rope_tables(pos, cfg.resolved_head_dim,
                                  cfg.rope_theta)
        q = ly.apply_rope(q, cos, sin)
        k = ly.apply_rope(k, cos, sin)
        window = (None if cfg.window_size is None
                  else GLOBAL_WINDOW if is_glob else cfg.window_size)
        if cache_k is not None:
            end = cache_pos + x.shape[1]
            cache_k[:, cache_pos:end] = k
            cache_v[:, cache_pos:end] = v
            o = ly.attention(q, cache_k, cache_v, q_pos=pos,
                             kv_pos=torch.arange(cache_k.shape[1],
                                                 device=x.device),
                             window=window, cap=cfg.attn_softcap,
                             kv_valid_len=end)
        elif ((attn_kernel is not None and window is None)
              or fa.kernel_takes(q, window, cfg.attn_softcap)):
            o = (attn_kernel or fa.flash_attention)(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                cap=cfg.attn_softcap).transpose(1, 2)
        else:
            o = ly.attention(q, k, v, q_pos=pos, kv_pos=pos, window=window,
                             cap=cfg.attn_softcap)
        attn_out = ly.gqa_out(lp["attn"], o)
    if "ln1b" in lp:
        attn_out = ly.rmsnorm(attn_out, lp["ln1b"], cfg.norm_eps)
    x = x + attn_out
    h = ly.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    aux = None
    if cfg.moe is None or "router" not in lp["mlp"]:
        # gelu under a soft-cap (gemma2), silu otherwise: the reference's
        # rule, so its GPT-3 MLP runs silu too (ROADMAP C.18)
        out = ly.mlp(lp["mlp"], h, gated=cfg.gated_mlp,
                     act=ly.gelu if cfg.attn_softcap else F.silu)
    elif moe_kernel is not None:
        out, aux = moe_kernel(lp["mlp"], h, cfg)
    else:
        out, aux = ly.moe_apply(lp["mlp"], h, cfg, n_groups=moe_groups,
                                impl=cfg.moe_impl, layer=moe_layer)
    if "ln2b" in lp:
        out = ly.rmsnorm(out, lp["ln2b"], cfg.norm_eps)
    return x + out, aux


def _mla_train_attention(q, k, v, pos):
    """MLA's causal attention without a cache, on (B, L, H, ·) tensors:
    the flash kernels (forward and backward) where ``fa.kernel_takes``
    the head dims (bf16 on the card: q and k at 192, v at 128, as
    DeepSeek-V2's), else ``ly.attention``."""
    if fa.kernel_takes(q, hd_v=v.shape[-1]):
        return fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2)).transpose(1, 2)
    return ly.attention(q, k, v, q_pos=pos, kv_pos=pos)


def _all_layers(params, cfg):
    """Every layer's parameters in order: the leading dense stack's, then
    ``layers``'."""
    n_dense = n_dense_layers(cfg)
    dense = (ly.layer_slices(params["dense_layers"], n_dense) if n_dense
             else [])
    return dense + ly.layer_slices(params["layers"], cfg.n_layers - n_dense)


def _layers(params, cfg, x, pos, cache=None, cache_pos=None, remat=False,
            **kw):
    """Every block in turn; returns (x after the final norm, summed aux).
    ``cache``: the stacked k/v or latent cache (not the pair layout).
    ``remat``: each block's activations recomputed in the backward."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    glob = _is_global(cfg)
    n_dense = n_dense_layers(cfg)
    for i, lp in enumerate(_all_layers(params, cfg)):
        kw.update(moe_layer=i - n_dense)
        if cache is not None and "latent" in cache:
            kw.update(cache_k=cache["latent"][i], cache_pos=cache_pos)
        elif cache is not None:
            kw.update(cache_k=cache["k"][i], cache_v=cache["v"][i],
                      cache_pos=cache_pos)
        if remat:
            x, a = checkpoint(partial(_block, cfg, is_glob=glob[i], **kw),
                              x, lp, pos, use_reentrant=False)
        else:
            x, a = _block(cfg, x, lp, pos, is_glob=glob[i], **kw)
        if a is not None:
            aux = aux + a
    return ly.rmsnorm(x, params["final_norm"], cfg.norm_eps), aux


def _embed(params, cfg, tokens, dtype):
    """The token embedding; gemma2 scales it by sqrt(d_model), the scale
    cast to the compute dtype BEFORE the multiply, as the reference's
    ``jnp.asarray(d_model ** 0.5, dtype)`` (in bf16 sqrt(3584) is 59.75,
    not 59.866)."""
    x = params["embed"].to(dtype)[tokens]
    if cfg.final_softcap is not None:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dtype,
                             device=x.device)
    return x


def embed_inputs(params, cfg, batch, dtype):
    """The token embedding, with the vision frontend's patch embeddings
    (cast to ``dtype``, projected through ``vis_proj``) before the
    tokens. Returns (x, n_prefix): the number of prefix positions."""
    x = _embed(params, cfg, batch["tokens"], dtype)
    if cfg.frontend != "vision" or "patch_embeds" not in batch:
        return x, 0
    vis = batch["patch_embeds"].to(dtype) @ params["vis_proj"].to(dtype)
    return torch.cat([vis, x], dim=1), vis.shape[1]


def _unembed(params, cfg, x):
    """Logits in the compute dtype; under a final soft-cap, soft-capped in
    f32 (so gemma2's logits are f32 in bf16 too)."""
    w = (params["embed"].T if cfg.tie_embeddings
         else params["lm_head"]).to(x.dtype)
    logits = x @ w
    if cfg.final_softcap is not None:
        logits = ly.softcap(logits.float(), cfg.final_softcap)
    return logits


def forward(params, cfg, batch, *, dtype=torch.bfloat16, moe_groups=1,
            remat=False, attn_kernel=None, moe_kernel=None):
    """Teacher-forced full-sequence forward. Returns (logits, aux_loss),
    the aux loss summed over the layers. A vision prefix is attended
    causally with the tokens, as in the reference; its logits are
    returned too."""
    x, _ = embed_inputs(params, cfg, batch, dtype)
    pos = torch.arange(x.shape[1], device=x.device)
    x, aux = _layers(params, cfg, x, pos, remat=remat, moe_groups=moe_groups,
                     attn_kernel=attn_kernel, moe_kernel=moe_kernel)
    return _unembed(params, cfg, x), aux


def _paired(cfg) -> bool:
    """Local/global alternation (gemma2) keeps its decode cache in the
    pair layout: a local layer holds only a window-long ring."""
    return (cfg.window_size is not None and cfg.global_every == 2
            and cfg.n_layers % 2 == 0)


def init_cache(cfg, batch_size: int, cache_len: int, dtype=torch.bfloat16,
               *, device):
    """The zero decode cache on ``device``, stacked over the layers (the
    pair layout when ``_paired``; MLA's latent cache)."""
    L = cfg.n_layers

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    if cfg.attn_kind == "mla":
        return {"latent": zeros(L, batch_size, cache_len,
                                cfg.mla.kv_lora_rank
                                + cfg.mla.qk_rope_head_dim)}
    kv = (cfg.n_kv_heads, cfg.resolved_head_dim)
    if _paired(cfg):
        P, wc = L // 2, min(cache_len, cfg.window_size)
        return {"k_loc": zeros(P, batch_size, wc, *kv),
                "v_loc": zeros(P, batch_size, wc, *kv),
                "k": zeros(P, batch_size, cache_len, *kv),
                "v": zeros(P, batch_size, cache_len, *kv)}
    return {"k": zeros(L, batch_size, cache_len, *kv),
            "v": zeros(L, batch_size, cache_len, *kv)}


def _ring_slot_pos(pos_max: int, W: int, device):
    """The position each ring slot holds when the newest is ``pos_max``:
    slot i holds the largest p <= pos_max with p % W == i (tensor ``%``
    takes the divisor's sign, as jnp's; ``torch.fmod`` would not)."""
    return pos_max - ((pos_max - torch.arange(W, device=device)) % W)


def _ring_attend(cfg, lp, x, pos, ck, cv, cache_pos: int):
    """A local layer's decode attention against its ring of W slots,
    written in place at slot ``cache_pos % W``. x (B, 1, d)."""
    W = ck.shape[1]
    q, k, v = ly.gqa_qkv(lp["attn"], x, cfg)
    cos, sin = ly.rope_tables(pos, cfg.resolved_head_dim, cfg.rope_theta)
    q, k = ly.apply_rope(q, cos, sin), ly.apply_rope(k, cos, sin)
    slot = cache_pos % W
    ck[:, slot:slot + x.shape[1]] = k
    cv[:, slot:slot + x.shape[1]] = v
    slot_pos = _ring_slot_pos(cache_pos, W, x.device)
    B, Lq, H, hd = q.shape
    KV = ck.shape[2]
    qf = q.reshape(B, Lq, KV, H // KV, hd).float()
    s = torch.einsum("bqghd,bkgd->bghqk", qf, ck.float())
    s = ly.softcap(s / (hd ** 0.5), cfg.attn_softcap)
    valid = (slot_pos >= 0) & (slot_pos <= cache_pos)
    s = torch.where(valid, s, ly.MASK_VALUE)
    p = torch.softmax(s, dim=-1).to(cv.dtype)
    o = torch.einsum("bghqk,bkgd->bqghd", p, cv).reshape(B, Lq, H, hd)
    return ly.gqa_out(lp["attn"], o)


def _local_tail(cfg, lp, x, attn):
    """A paired local layer after its attention: the post-norms and the
    MLP with ``ly.mlp``'s default gelu, as the reference's pair loops
    call it (transformer.py:249, :326; ROADMAP C.20)."""
    if "ln1b" in lp:
        attn = ly.rmsnorm(attn, lp["ln1b"], cfg.norm_eps)
    x = x + attn
    h = ly.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    out = ly.mlp(lp["mlp"], h, gated=cfg.gated_mlp)
    if "ln2b" in lp:
        out = ly.rmsnorm(out, lp["ln2b"], cfg.norm_eps)
    return x + out


def _decode_paired(params, cfg, x, cache, start_pos: int, moe_groups):
    """Decode through the pairs: the local layer against its ring, the
    global one against its full cache. Returns x after the final norm."""
    pos = start_pos + torch.arange(x.shape[1], device=x.device)
    layers = ly.layer_slices(params["layers"], cfg.n_layers)
    for j, (lp_loc, lp_glob) in enumerate(zip(layers[::2], layers[1::2])):
        h = ly.rmsnorm(x, lp_loc["ln1"], cfg.norm_eps)
        attn = _ring_attend(cfg, lp_loc, h, pos, cache["k_loc"][j],
                            cache["v_loc"][j], start_pos)
        x = _local_tail(cfg, lp_loc, x, attn)
        x, _ = _block(cfg, x, lp_glob, pos, cache_k=cache["k"][j],
                      cache_v=cache["v"][j], cache_pos=start_pos,
                      moe_groups=moe_groups)
    return ly.rmsnorm(x, params["final_norm"], cfg.norm_eps)


def _prefill_paired(params, cfg, x, cache, moe_groups):
    """Prefill in the pair layout: a local layer attends through its
    window over the prompt and keeps the last W keys and values in ring
    order (slot i <- prompt position p_i, the largest p <= Lq - 1 with
    p % W == i, clipped at 0: decode masks those slots); a global layer
    fills its full cache from position 0."""
    Lq = x.shape[1]
    pos = torch.arange(Lq, device=x.device)
    W = cache["k_loc"].shape[2]
    p_i = (Lq - 1) - ((Lq - 1 - torch.arange(W, device=x.device)) % W)
    gather = p_i.clamp(min=0)
    layers = ly.layer_slices(params["layers"], cfg.n_layers)
    for j, (lp_loc, lp_glob) in enumerate(zip(layers[::2], layers[1::2])):
        h = ly.rmsnorm(x, lp_loc["ln1"], cfg.norm_eps)
        q, k, v = ly.gqa_qkv(lp_loc["attn"], h, cfg)
        cos, sin = ly.rope_tables(pos, cfg.resolved_head_dim,
                                  cfg.rope_theta)
        q, k = ly.apply_rope(q, cos, sin), ly.apply_rope(k, cos, sin)
        o = ly.attention(q, k, v, q_pos=pos, kv_pos=pos,
                         window=cfg.window_size, cap=cfg.attn_softcap)
        x = _local_tail(cfg, lp_loc, x, ly.gqa_out(lp_loc["attn"], o))
        cache["k_loc"][j] = k[:, gather]
        cache["v_loc"][j] = v[:, gather]
        x, _ = _block(cfg, x, lp_glob, pos, cache_k=cache["k"][j],
                      cache_v=cache["v"][j], cache_pos=0,
                      moe_groups=moe_groups)
    return ly.rmsnorm(x, params["final_norm"], cfg.norm_eps)


def _with_cache(params, cfg, x, cache, start_pos: int, moe_groups):
    """Every block on the embedded ``x`` at ``start_pos`` against the
    stacked k/v or latent cache; returns x after the final norm."""
    pos = start_pos + torch.arange(x.shape[1], device=x.device)
    x, _ = _layers(params, cfg, x, pos, cache, start_pos,
                   moe_groups=moe_groups)
    return x


def prefill(params, cfg, batch, cache, *, dtype=torch.bfloat16,
            moe_groups=1):
    """Run the prompt (after its vision prefix, if any), writing its cache
    entries into ``cache`` from position 0; returns (last-token logits
    (B, 1, V), the cache)."""
    x, _ = embed_inputs(params, cfg, batch, dtype)
    if _paired(cfg) and "k_loc" in cache:
        x = _prefill_paired(params, cfg, x, cache, moe_groups)
    else:
        x = _with_cache(params, cfg, x, cache, 0, moe_groups)
    return _unembed(params, cfg, x[:, -1:]), cache


def decode_step(params, cfg, tokens, cache, pos, *, dtype=torch.bfloat16,
                moe_groups=1):
    """One token per sequence against the cache. tokens (B, 1); ``pos``
    is the number of positions already in the cache, a vision prefix
    included. Returns (logits (B, 1, V), the cache)."""
    x = _embed(params, cfg, tokens, dtype)
    if _paired(cfg) and "k_loc" in cache:
        x = _decode_paired(params, cfg, x, cache, int(pos), moe_groups)
    else:
        x = _with_cache(params, cfg, x, cache, int(pos), moe_groups)
    return _unembed(params, cfg, x), cache
