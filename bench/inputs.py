"""The inputs a run hands to the program and to the reference alike: the
share's weights, made from the seed on the device (by default in one
draw), in the type the program trains them in (bfloat16), and the sizes
of the state.
What a family names, its leaves and their shapes, comes from its module
in ``bench/families/``."""
from __future__ import annotations

import math

import torch

from bench import common

#: bytes of training state per parameter: bfloat16 weights, float32
#: master weights, first and second moments
STATE_BYTES_PER_PARAM = 2 + 4 + 4 + 4


def param_shapes(cfg: dict) -> dict:
    """``{name: (shape, fan_in)}`` of the share's parameters, named as the
    checkpoint names them, from the configuration's family module;
    ``fan_in`` is None for a norm's scale."""
    return common.family(cfg).param_shapes(cfg)


def param_count(cfg: dict) -> int:
    return sum(math.prod(s) for s, _ in param_shapes(cfg).values())


def state_bytes(cfg: dict) -> int:
    """Bytes of one save of the training state (the int32 step
    included)."""
    return param_count(cfg) * STATE_BYTES_PER_PARAM + 4


def make_weights(cfg: dict, seed: int, device) -> dict:
    """``{name: bfloat16 tensor}`` from ``seed``: the family module's own
    ``make_weights`` where it has one, else ``uniform_weights``."""
    fam = common.family(cfg)
    if hasattr(fam, "make_weights"):
        return fam.make_weights(cfg, seed, device)
    return uniform_weights(param_shapes(cfg), seed, device)


def uniform_weights(shapes: dict, seed: int, device) -> dict:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for the matrices of ``shapes``
    (``param_shapes``' form), ones for the norms, from one draw of a
    generator on ``device`` seeded with ``seed``, over the matrices in the
    order of their names."""
    matrices = [(n, s, f) for n, (s, f) in sorted(shapes.items()) if f]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(sum(math.prod(s) for _, s, _ in matrices),
                   generator=gen, device=device)
    out, pos = {}, 0
    for name, shape, fan_in in matrices:
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
