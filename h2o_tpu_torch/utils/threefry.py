"""The ``jax.random`` calls the tree engine makes, bit for bit
(``jax/_src/prng.py``, threefry2x32 with ``jax_threefry_partitionable``
on, jax's default since 0.5).

A key is what ``jax.random.PRNGKey`` holds: a (2,) uint32 numpy array.
Keys are derived on the host — ``prng_key``, ``fold_in`` and ``split`` are a
handful of hashes of known integers — so deriving one never touches or
waits for the device. Only ``random_bits`` and ``uniform`` make tensors,
with torch integer ops on the device they are given.

In the partitionable mode:
- ``fold_in(key, d)`` hashes the counter pair (0, d): the two words out are
  the new key;
- ``split(key, n)[i]`` hashes (0, i), so it equals ``fold_in(key, i)``;
- ``random_bits(key, shape)`` hashes (hi, lo), the 64-bit flat index of
  each element, and keeps the XOR of the two words out;
- ``uniform`` puts the top 23 bits of those into a float32 mantissa in
  [1, 2) and subtracts 1.

Words are held in int64 and masked to 32 bits after every op, on the host
(numpy) and on the device (torch) alike: torch's uint32 covers too few ops.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _threefry2x32(k1: int, k2: int, x1, x2):
    """The threefry2x32 hash (20 rounds) of counter words ``x1``, ``x2``
    (int64 numpy arrays or torch tensors holding 32-bit words) under the
    key (``k1``, ``k2``); returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = ((x2 << r) | (x2 >> (32 - r))) & _MASK
            x2 = x1 ^ x2
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x1, x2


def _key_words(key) -> tuple[int, int]:
    k = np.asarray(key, dtype=np.uint32)
    return int(k[0]), int(k[1])


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: the seed's high and low 32-bit words."""
    s = int(seed)
    return np.array([(s >> 32) & _MASK, s & _MASK], dtype=np.uint32)


def split(key, n: int) -> np.ndarray:
    """``jax.random.split(key, n)``: (n, 2) uint32 keys."""
    k1, k2 = _key_words(key)
    lo = np.arange(n, dtype=np.int64)
    b1, b2 = _threefry2x32(k1, k2, np.zeros_like(lo), lo)
    return np.stack([b1, b2], axis=1).astype(np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for a data value in [0, 2^32)."""
    k1, k2 = _key_words(key)
    b1, b2 = _threefry2x32(k1, k2, np.zeros(1, np.int64),
                           np.array([int(data) & _MASK], np.int64))
    return np.array([b1[0], b2[0]], dtype=np.uint32)


def random_bits(key, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32-bit): one word per element, held
    in an int64 tensor on ``device``."""
    k1, k2 = _key_words(key)
    shape = tuple(int(s) for s in shape)
    idx = torch.arange(int(np.prod(shape, dtype=np.int64)), dtype=torch.int64,
                       device=device)
    b1, b2 = _threefry2x32(k1, k2, idx >> 32, idx & _MASK)
    return (b1 ^ b2).reshape(shape)


def uniform(key, shape, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in float32 on [0, 1)."""
    bits = random_bits(key, shape, device)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0
