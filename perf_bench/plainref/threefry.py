"""JAX's default PRNG (threefry2x32, partitionable) on NumPy uint32
words: ``split`` and ``normal`` as the simulation draws its noise.

A key is a pair of uint32 words (k0, k1).  ``split(key, n)`` gives key i
= threefry((k0, k1), (0, i)); ``bits(key, n)`` gives, per counter i, the
xor of the two output words of threefry((k0, k1), (0, i));
``normal(key, n)`` maps each 32-bit word to a uniform in
(nextafter(-1, 0), 1) by its top 23 bits and returns sqrt(2) erfinv(u),
here in float64.
"""

from __future__ import annotations

import numpy as np
from scipy.special import erfinv

ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = np.uint32(0x1BD11BDA)


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry(k0, k1, c0, c1):
    """Threefry-2x32 with 20 rounds over broadcast uint32 arrays."""
    with np.errstate(over="ignore"):
        ks = (k0, k1, k0 ^ k1 ^ PARITY)
        x0, x1 = c0 + ks[0], c1 + ks[1]
        for g in range(5):
            for r in ROT[g % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(g + 1) % 3]
            x1 = x1 + ks[(g + 2) % 3] + np.uint32(g + 1)
    return x0, x1


def _counters(key, n):
    key = np.asarray(key, np.uint64).astype(np.uint32)
    k0 = key[..., 0][..., None]
    k1 = key[..., 1][..., None]
    i = np.arange(n, dtype=np.uint32)
    return threefry(k0, k1, np.zeros_like(i), i)


def split(key, n: int) -> np.ndarray:
    """key (..., 2) -> (..., n, 2) uint32."""
    a, b = _counters(key, n)
    return np.stack([a, b], -1)


def normal(key, n: int) -> np.ndarray:
    """key (..., 2) -> (..., n) standard normals, float64."""
    a, b = _counters(key, n)
    bits = a ^ b
    f = (bits >> np.uint32(9)).astype(np.float64) / 2.0 ** 23   # [0, 1)
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = np.maximum(f * (1.0 - lo) + lo, lo)
    return np.sqrt(2.0) * erfinv(u)
