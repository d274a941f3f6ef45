"""Sums whose order of additions is fixed, whatever the batch.

A library reduction or a batched ``matmul`` may split its summed axis
otherwise at another batch size (the anchor matcher's 4 x 4 products did
on the card at 60 rows), so a row's result would depend on the rows beside
it.  These
sum with one broadcast multiply and slice adds in an order set by the
summed axis' length alone: each element is rounded the same at any batch
size, on the CPU and on the card.
"""

from __future__ import annotations

import torch


def seq_sum(x, dim: int):
    """``x`` summed over the short axis ``dim`` left to right, one slice add
    at a time: the order of the additions is fixed, whatever the batch."""
    acc = x.select(dim, 0)
    for i in range(1, x.shape[dim]):
        acc = acc + x.select(dim, i)
    return acc


def tree_sum(x, dim: int):
    """``x`` summed over ``dim`` (kept, of size 1) by a fixed pairwise tree
    of slice adds, log2 of its length deep: the halves of the even part
    added, an odd last slice carried to the next level.  The order depends
    on the axis' length alone, not on the batch."""
    n = x.shape[dim]
    while n > 1:
        h = n // 2
        s = x.narrow(dim, 0, h) + x.narrow(dim, h, h)
        x = s if n % 2 == 0 else torch.cat([s, x.narrow(dim, 2 * h, 1)], dim)
        n = x.shape[dim]
    return x


def sqrt(x):
    """The square root correctly rounded on every device: a float32 root is
    taken in float64 (exact to the last float32 bit) because ATen's
    vectorized float32 ``sqrt`` on the CPU is not correctly rounded (it
    misses the last bit on ~0.6 % of inputs); the card's is, and so is this
    on both."""
    if x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def mm(a, b):
    """a (..., n, m) @ b (..., m, p) for small matrices: one broadcast
    multiply and a left-to-right sum over m (``seq_sum``), so each element
    is rounded the same at any batch size and on any device."""
    return seq_sum(a[..., :, :, None] * b[..., None, :, :], -2)
