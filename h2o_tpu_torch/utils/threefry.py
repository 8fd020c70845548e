"""The ``jax.random`` calls the port's models make, bit for bit
(``jax/_src/prng.py`` and ``random.py``, threefry2x32 with
``jax_threefry_partitionable`` on, jax's default since 0.5): the tree
engine's bits and uniforms, and DeepLearning's, KMeans' and PCA's
uniforms on a range, normals, permutations, ``choice`` draws and the
isolation forests' ``randint``.

A key is what ``jax.random.PRNGKey`` holds: a (2,) uint32 numpy array.
Keys are derived on the host — ``prng_key``, ``fold_in`` and ``split`` are a
handful of hashes of known integers — so deriving one never touches or
waits for the device. The draws make tensors with torch ops on the device
they are given.

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


def uniform(key, shape, device=None, minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=, maxval=)`` in float32, as
    ``_uniform`` computes it: the float in [0, 1) times ``maxval - minval``
    (both first rounded to float32) plus ``minval``, then ``max(minval,
    ·)``. XLA's CPU backend contracts the multiply-add into one FMA (a
    single rounding), so it is done here in float64, where the float32
    product is exact, and rounded once."""
    bits = random_bits(key, shape, device)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    if minval == 0.0 and maxval == 1.0:
        return floats
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=device)
    fma = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, fma)


#: XLA's float32 ``erf_inv`` (Giles' approximation): a degree-8
#: polynomial in w = −log1p(−x²) − 2.5 for w < 5, in √w − 3 beyond
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` with its Horner steps contracted to FMAs,
    as its CPU backend runs them. ``torch.log1p`` and XLA's ``log1p`` may
    round differently: the result stays within 2 ulps of the reference's
    (``torch.erfinv`` is a different approximation, many ulps away)."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).double()
    coef = [torch.where(small, np.float32(a).item(), np.float32(b).item())
            for a, b in zip(_ERFINV_SMALL, _ERFINV_LARGE)]
    p = coef[0].to(x.dtype)
    for c in coef[1:]:
        p = (c.double() + p.double() * w).float()
    return torch.where(x.abs() == 1.0, x * torch.inf,
                       p * x)


def normal(key, shape, device=None) -> torch.Tensor:
    """``jax.random.normal`` in float32 (``_normal_real``): √2 · erfinv(u),
    u uniform on (nextafter(−1, 0), 1), bit-equal to the reference's in
    ~99% of draws and within 3 ulps in all (``_erf_inv``'s 2, and the
    product's rounding)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, device, minval=lo, maxval=1.0)
    return np.float32(np.sqrt(2.0)).item() * _erf_inv(u)


def randint(key, shape, minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` for int32 bounds
    (``_randint``): two 32-bit words per element from the halves of
    ``split(key)``, folded into the span with uint32 arithmetic — ``(hi %
    span) * m + lo % span`` with ``m = (2^16 % span)^2 % span``, each
    product and sum wrapping at 2^32 (so ``m`` is 0 for a span above
    2^16), then ``% span`` once more. A span of 0 or less draws ``minval``.
    int64 on ``device``."""
    span = max(int(maxval) - int(minval), 1)
    k1, k2 = split(key, 2)
    hi = random_bits(k1, shape, device)
    lo = random_bits(k2, shape, device)
    mult = ((2 ** 16 % span) ** 2 & _MASK) % span   # 0 past 2^16
    off = ((hi % span) * mult) & _MASK
    off = ((off + lo % span) & _MASK) % span
    return off + int(minval)


def permutation(key, n: int, device=None) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` (``_shuffle`` of ``arange(n)``):
    ⌈3·ln n / ln(2³²−1)⌉ rounds, each splitting the key, drawing one 32-bit
    sort key per position and stable-sorting the values by them. int64 on
    ``device``."""
    x = torch.arange(n, dtype=torch.int64, device=device)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(_MASK)))
    for _ in range(rounds):
        key, sub = split(key, 2)
        order = torch.sort(random_bits(sub, (n,), device), stable=True).indices
        x = x[order]
    return x


def cumsum(p: torch.Tensor) -> torch.Tensor:
    """float32 ``jnp.cumsum`` of a 1-D tensor as XLA's CPU backend runs it:
    its reduce-window rewrite scans blocks of 16 elements left to right,
    scans the block totals the same way (recursively) and adds each block
    the exclusive prefix of the totals before it. Bit-equal to the
    reference's cumsum; ``torch.cumsum`` on the CPU accumulates in float64
    and rounds each prefix once, which differs in the last bit."""
    n = p.shape[0]
    b = 16
    nb = -(-n // b)
    xp = torch.zeros(nb * b, dtype=torch.float32, device=p.device)
    xp[:n] = p
    inner = xp.reshape(nb, b).clone()
    for j in range(1, b):
        inner[:, j] = inner[:, j - 1] + inner[:, j]
    if nb == 1:
        return inner.reshape(-1)[:n]
    tot = cumsum(inner[:, -1].contiguous())
    excl = torch.cat([tot.new_zeros(1), tot[:-1]])
    return (inner + excl[:, None]).reshape(-1)[:n]


def gumbel(key, n: int, device=None) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,))`` in its default "low" mode:
    −log(−log(u)), u uniform on [tiny, 1)."""
    tiny = float(np.finfo(np.float32).tiny)
    u = uniform(key, (n,), device, minval=tiny, maxval=1.0)
    return -torch.log(-torch.log(u))


def choice(key, n: int, shape=(), replace: bool = True, p=None,
           device=None) -> torch.Tensor:
    """``jax.random.choice(key, n, shape, replace, p)``, int64 indices, in
    the three forms of the installed JAX:

    - ``p`` and ``replace``: r = cumsum(p)[-1] · (1 − u), then the first
      index whose cumulative sum reaches r (``searchsorted``, left);
    - ``p`` without ``replace``: the top k of Gumbel noise + log p, the
      lower index first on ties;
    - no ``p``, no ``replace``: the first k of a permutation.

    (``replace`` without ``p`` is ``randint``: call it.)"""
    shape = tuple(int(s) for s in shape)
    k = int(np.prod(shape, dtype=np.int64))
    if p is None:
        if replace:
            raise NotImplementedError("choice(replace=True) without p: "
                                      "use threefry.randint")
        return permutation(key, n, device)[:k].reshape(shape)
    p = p.to(torch.float32)
    if replace:
        c = cumsum(p)
        r = c[-1] * (1.0 - uniform(key, shape, p.device))
        return torch.searchsorted(c, r.reshape(-1)).reshape(shape)
    g = gumbel(key, n, p.device) + torch.log(p)
    order = torch.sort(g, descending=True, stable=True).indices
    return order[:k].reshape(shape)
