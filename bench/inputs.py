"""The inputs a run hands to the program and to the reference alike: the
share's weights, made from the seed on the device in one draw, in the
type the program trains them in (bfloat16)."""
from __future__ import annotations

import math

import torch

#: bytes of training state per parameter: bfloat16 weights, float32
#: master weights, first and second moments
STATE_BYTES_PER_PARAM = 2 + 4 + 4 + 4


def param_shapes(cfg: dict) -> dict:
    """``{name: (shape, fan_in)}`` of the share's parameters, named as the
    checkpoint names them; ``fan_in`` is None for a norm's scale."""
    d, H, hd = cfg["d_model"], cfg["n_heads"], cfg["head_dim"]
    L, ff, V = cfg["n_layers"], cfg["d_ff"], cfg["vocab_size"]
    shapes = {
        "embed": ((V, d), d),
        "final_norm": ((d,), None),
        "layers/attn/wq": ((L, d, H * hd), d),
        "layers/attn/wk": ((L, d, H * hd), d),
        "layers/attn/wv": ((L, d, H * hd), d),
        "layers/attn/wo": ((L, H * hd, d), H * hd),
        "layers/ln1": ((L, d), None),
        "layers/ln2": ((L, d), None),
        "layers/mlp/wi": ((L, d, ff), d),
        "layers/mlp/wo": ((L, ff, d), ff),
    }
    if cfg.get("gated_mlp"):
        shapes["layers/mlp/wg"] = ((L, d, ff), d)
    return shapes


def param_count(cfg: dict) -> int:
    return sum(math.prod(s) for s, _ in param_shapes(cfg).values())


def state_bytes(cfg: dict) -> int:
    """Bytes of one save of the training state (the int32 step
    included)."""
    return param_count(cfg) * STATE_BYTES_PER_PARAM + 4


def make_weights(cfg: dict, seed: int, device) -> dict:
    """``{name: bfloat16 tensor}``: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for
    the matrices, ones for the norms, from one draw of a generator on
    ``device`` seeded with ``seed``."""
    shapes = param_shapes(cfg)
    dense = [(n, s, f) for n, (s, f) in sorted(shapes.items()) if f]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(sum(math.prod(s) for _, s, _ in dense),
                   generator=gen, device=device)
    out, pos = {}, 0
    for name, shape, fan_in in dense:
        n = math.prod(shape)
        scale = 1.0 / math.sqrt(fan_in)
        out[name] = u[pos:pos + n].mul(2 * scale).sub_(scale).to(
            torch.bfloat16).reshape(shape)
        pos += n
    del u
    for name, (shape, fan_in) in shapes.items():
        if fan_in is None:
            out[name] = torch.ones(shape, dtype=torch.bfloat16,
                                   device=device)
    return out
