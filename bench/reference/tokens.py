"""The token stream the trainer reads, worked out again from its seed.

A frozen copy of the arithmetic of the counter-based stream that the
program's data pipeline documents: JAX's ``PRNGKey``, ``fold_in``,
``split`` and ``randint`` over Threefry-2x32 (the partitionable counter
layout), in numpy. Batch ``i`` of seed ``s`` is ``randint(split(fold_in(
PRNGKey(s), i))[0], (batch, seq + 1), 0, vocab)``: tokens are its first
``seq`` columns and labels its last ``seq``.
"""
from __future__ import annotations

import numpy as np

_M32 = np.uint64(0xFFFFFFFF)
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r):
    return ((v << np.uint32(r)) | (v >> np.uint32(32 - r))).astype(np.uint32)


def threefry2x32(key, x0, x1):
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
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF if seed >= 0 else 0,
                     seed & 0xFFFFFFFF], np.uint32)


def _iota_2x32(n: int):
    i = np.arange(n, dtype=np.uint64)
    return (((i >> np.uint64(32)) & _M32).astype(np.uint32),
            (i & _M32).astype(np.uint32))


def fold_in(key, data: int) -> np.ndarray:
    a, b = threefry2x32(key, np.zeros(1, np.uint32),
                        np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([a[0], b[0]], np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    a, b = threefry2x32(key, *_iota_2x32(num))
    return np.stack([a, b], axis=1)


def random_bits(key, shape) -> np.ndarray:
    a, b = threefry2x32(key, *_iota_2x32(int(np.prod(shape))))
    return (a ^ b).reshape(shape)


def randint(key, shape, minval: int, maxval: int) -> np.ndarray:
    k1, k2 = split(key)
    higher = random_bits(k1, shape).astype(np.uint64)
    lower = random_bits(k2, shape).astype(np.uint64)
    span = np.uint64(max(int(maxval) - int(minval), 1) & 0xFFFFFFFF)
    mult = np.uint64(2 ** 16) % span
    mult = (mult * mult & _M32) % span
    off = (((higher % span) * mult & _M32) + lower % span) & _M32
    return (np.int64(minval) + (off % span).astype(np.int64)).astype(np.int32)


def batch(seed: int, index: int, vocab: int, rows: int, seq: int):
    """(tokens, labels), each an int32 array of shape (rows, seq)."""
    k1, _ = split(fold_in(prng_key(seed), index))
    ids = randint(k1, (rows, seq + 1), 0, vocab)
    return ids[:, :-1], ids[:, 1:]
