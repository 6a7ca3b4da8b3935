"""Checkpointable synthetic data pipeline (the counterpart of
``repro.data.pipeline``).

The paper's checkpoint state includes the data-loading iterator
(§2.1.3). The stream is a deterministic counter-based token stream whose
full state is {seed, position}; it rides in the checkpoint's ``extras``.

It yields THE SAME token ids as the reference, so a port trainer that
resumes from a reference checkpoint reads the same stream: the
reference draws them with ``jax.random`` (threefry2x32, partitionable
counter layout — the default since JAX 0.5), reimplemented here in
numpy: ``PRNGKey``, ``fold_in``, ``split`` and ``randint``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import spans

_M32 = np.uint64(0xFFFFFFFF)
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r):
    return ((v << np.uint32(r)) | (v >> np.uint32(32 - r))).astype(np.uint32)


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds), elementwise over the
    uint32 counter arrays ``x0``, ``x1``. Returns two uint32 arrays."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, np.uint32(k0 ^ k1 ^ np.uint32(0x1BD11BDA)))
    with np.errstate(over="ignore"):
        a = (np.asarray(x0, np.uint32) + ks[0]).astype(np.uint32)
        b = (np.asarray(x1, np.uint32) + ks[1]).astype(np.uint32)
        for i in range(5):
            for r in _ROT[i % 2]:
                a = (a + b).astype(np.uint32)
                b = _rotl(b, r) ^ a
            a = (a + ks[(i + 1) % 3]).astype(np.uint32)
            b = (b + ks[(i + 2) % 3] + np.uint32(i + 1)).astype(np.uint32)
    return a, b


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: the seed's high and low 32 bits."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF if seed >= 0 else 0,
                     seed & 0xFFFFFFFF], np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in``: threefry of the key over [0, data]."""
    a, b = threefry2x32(key, np.zeros(1, np.uint32),
                        np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([a[0], b[0]], np.uint32)


def _iota_2x32(n: int):
    """High and low 32-bit halves of a 64-bit iota of length ``n``."""
    i = np.arange(n, dtype=np.uint64)
    return ((i >> np.uint64(32)) & _M32).astype(np.uint32), \
        (i & _M32).astype(np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split`` (partitionable layout): ``(num, 2)`` keys."""
    hi, lo = _iota_2x32(num)
    a, b = threefry2x32(key, hi, lo)
    return np.stack([a, b], axis=1)


def random_bits(key, shape) -> np.ndarray:
    """32 uniform random bits per element (partitionable layout)."""
    n = int(np.prod(shape))
    hi, lo = _iota_2x32(n)
    a, b = threefry2x32(key, hi, lo)
    return (a ^ b).reshape(shape)


def randint(key, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval, int32)``: two
    32-bit draws folded into [minval, maxval) modulo the span, with the
    reference's uint32 wrap-around arithmetic."""
    k1, k2 = split(key)
    higher = random_bits(k1, shape).astype(np.uint64)
    lower = random_bits(k2, shape).astype(np.uint64)
    span = np.uint64(max(int(maxval) - int(minval), 1) & 0xFFFFFFFF)
    mult = np.uint64(2 ** 16) % span
    mult = (mult * mult & _M32) % span
    off = (((higher % span) * mult & _M32) + lower % span) & _M32
    return (np.int64(minval) + (off % span).astype(np.int64)).astype(np.int32)


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


class TokenStream:
    """Deterministic, seekable token stream. batch(i) is a pure function
    of (seed, i): restoring from {seed, position} is exact. Batches are
    int32 tensors on ``device``."""

    def __init__(self, cfg: DataConfig, position: int = 0, device="cpu"):
        self.cfg = cfg
        self.position = position
        self.device = torch.device(device)

    def state(self) -> dict:
        return {"seed": self.cfg.seed, "position": self.position}

    @classmethod
    def from_state(cls, cfg: DataConfig, state: dict,
                   device="cpu") -> "TokenStream":
        assert state["seed"] == cfg.seed, "seed mismatch on restore"
        return cls(cfg, position=int(state["position"]), device=device)

    def _batch_at(self, index: int):
        with spans.span("data.draw"):
            key = fold_in(prng_key(self.cfg.seed), index)
            k1, _k2 = split(key)
            tokens = randint(k1, (self.cfg.global_batch,
                                  self.cfg.seq_len + 1),
                             0, self.cfg.vocab_size)
        with spans.span("data.h2d", tokens.nbytes):
            tokens = torch.from_numpy(tokens).to(self.device)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def __next__(self):
        b = self._batch_at(self.position)
        self.position += 1
        return b

    def __iter__(self):
        return self

    def peek(self, index: int):
        return self._batch_at(index)
