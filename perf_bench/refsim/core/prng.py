"""JAX's threefry2x32 counter-based PRNG, reproduced bit for bit in torch.

The simulation's noise streams (wheel slip, feature dropout, pixel and depth
noise, descriptor bit flips) are drawn from ``jax.random`` keys in the JAX
package.  To hold the port step-for-step against it, the same keys must give
the same bits, so this module re-implements JAX's default PRNG as it behaves
with ``jax_threefry_partitionable=True`` (the default since JAX 0.5):

- a key is a pair of uint32 words, stored here as an int64 tensor (..., 2)
  with values in [0, 2**32) — torch's uint32 arithmetic is incomplete, so
  every 32-bit operation is done in int64 and masked;
- ``split``/``random_bits`` hash a 64-bit iota (high word, low word) with
  the key; ``fold_in`` hashes the pair (0, data);
- ``uniform`` fills the float32 mantissa with the top 23 bits, ``normal`` is
  ``sqrt(2) * erfinv(u)`` with XLA's float32 ``erfinv`` polynomial, and
  ``bernoulli`` is ``uniform < p``.

Keys may carry leading batch dimensions (one key per route): every function
maps over them, like ``jax.vmap`` over a key batch.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block hash (20 rounds), elementwise over
    broadcastable int64 tensors holding uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def PRNGKey(seed: int, device) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: the pair (0, seed)."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=device)


def _hash(key, shape):
    """threefry over the flattened iota of ``shape`` (counts < 2**32, so the
    iota's high word is 0).  key (..., 2) -> two (..., *shape) tensors."""
    n = int(np.prod(shape)) if len(shape) else 1
    lo = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    k1 = key[..., 0].reshape(key.shape[:-1] + (1,) * len(shape))
    k2 = key[..., 1].reshape(key.shape[:-1] + (1,) * len(shape))
    return threefry2x32(k1, k2, torch.zeros_like(lo), lo)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def split(key, num=2) -> torch.Tensor:
    """``jax.random.split``: key (..., 2) -> (..., *num, 2)."""
    b1, b2 = _hash(key, _shape(num))
    return torch.stack([b1, b2], -1)


def fold_in(key, data: int) -> torch.Tensor:
    """``jax.random.fold_in`` with a non-negative 32-bit ``data``."""
    zero = torch.zeros((), dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], zero,
                          zero + (int(data) & MASK32))
    return torch.stack([b1, b2], -1)


def random_bits(key, shape=()) -> torch.Tensor:
    """32 random bits per element (``jax.random.bits``), as int64."""
    b1, b2 = _hash(key, _shape(shape))
    return b1 ^ b2


def _fma(a, b, c):
    """float32 ``a * b + c`` with one rounding, as XLA emits it: the f32
    product is exact in float64, so only the final sum rounds (twice, which
    differs from a fused multiply-add in ~2**-29 of cases).  b and c are
    float32 tensors or float32-valued Python floats."""
    if isinstance(b, torch.Tensor):
        b = b.double()
    if isinstance(c, torch.Tensor):
        c = c.double()
    return (a.double() * b + c).float()


def uniform(key, shape=(), minval=0.0, maxval=1.0) -> torch.Tensor:
    """float32 uniform in [minval, maxval) (``jax.random.uniform``)."""
    bits = random_bits(key, shape)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    lo = np.float32(minval)
    span = np.float32(maxval) - lo          # float32 arithmetic, as in JAX
    return _fma(floats, float(span), float(lo)).clamp_min(float(lo))


# XLA's float32 erfinv (Giles' single-precision approximation): the
# polynomial coefficients for w < 5 and w >= 5, highest degree first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function evaluated the way XLA lowers it."""
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).to(torch.float32)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = torch.where(lt, a, b).to(torch.float32)
        p = _fma(p, w, c)
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2_F32 = float(np.float32(np.sqrt(2.0)))


def normal(key, shape=()) -> torch.Tensor:
    """float32 standard normal (``jax.random.normal``)."""
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    return _SQRT2_F32 * erfinv(u)


def bernoulli(key, p, shape=None) -> torch.Tensor:
    """``jax.random.bernoulli`` (mode "low"): ``uniform < p``.  ``p`` is a
    float or a float32 tensor whose shape, without the key's batch
    dimensions, is the sample shape when ``shape`` is None."""
    if shape is None:
        shape = tuple(p.shape[key.dim() - 1:])
    return uniform(key, shape) < p


def randint(key, shape, minval, maxval) -> torch.Tensor:
    """``jax.random.randint`` for int32: integers in [minval, maxval).

    ``minval``/``maxval`` are ints or integer tensors of the key's batch
    shape (one bound per key).  JAX draws two 32-bit words per value from
    the key's two halves and folds them with ``2**32 % span`` (computed as
    ``(2**16 % span)**2 % span`` in wrapping uint32 arithmetic), which is
    reproduced here in int64 with 32-bit masks."""
    shape = _shape(shape)
    k1, k2 = split(key).unbind(-2)
    hi, lo = random_bits(k1, shape), random_bits(k2, shape)
    batch = key.shape[:-1] + (1,) * len(shape)

    def bound(v):
        v = torch.as_tensor(v, dtype=torch.int64, device=key.device)
        return v.reshape(batch) if v.dim() else v

    minval, maxval = bound(minval), bound(maxval)
    span = torch.where(maxval <= minval, torch.ones_like(maxval),
                       (maxval - minval) & MASK32)
    mult = (65536 % span)
    mult = ((mult * mult) & MASK32) % span
    off = (((hi % span) * mult) & MASK32) + lo % span
    off = (off & MASK32) % span
    return (minval + off).to(torch.int32)
