"""Mutual-nearest-neighbour Hamming matching, plain PyTorch only.

``cross_check(desc_a, valid_a, desc_b, valid_b, max_dist)`` matches each
row of ``a`` (P, A, W) to its nearest row of ``b`` (Q, B, W) over W 32-bit
words and keeps mutual matches within ``max_dist``; problem p reads b set
``p // (P // Q)``.  Returns ``best_b`` (P, A) int32 (the first nearest b
among ties), ``matched`` (P, A) bool and ``best_d`` (P, A) int32; an
invalid row gives b = 0, d = BIG, unmatched.  The reference's stand-in for
the port's kernel K1, by the distances and keys that kernel is held to.
"""

from __future__ import annotations

import torch

BIG = 10 ** 6
INT32_MAX = 2 ** 31 - 1
WORDS = 8          # the kernel's descriptor width (256 bits)


def popcount32(x):
    """Set bits of 32-bit words (SWAR, exact), held as int32 (two's
    complement: the masks clear every sign-extended bit) or as int64 values
    in [0, 2**32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _as_int32(d):
    """int64 words in [0, 2**32) -> the same 32 bits as int32."""
    return torch.where(d >= 2 ** 31, d - 2 ** 32, d).to(torch.int32)


def hamming_plain(d1, d2):
    """Pairwise Hamming distance (..., A, W) x (..., B, W) -> (..., A, B)
    int32.  The xor and popcount run on int32 words: half the bytes of the
    int64 tensors."""
    x = _as_int32(d1)[..., :, None, :] ^ _as_int32(d2)[..., None, :, :]
    return popcount32(x).sum(-1, dtype=torch.int32)


def _expand_b(desc_b, valid_b, P: int):
    group = P // desc_b.shape[0]
    if group == 1:
        return desc_b, valid_b
    return (desc_b.repeat_interleave(group, 0),
            valid_b.repeat_interleave(group, 0))


def cross_check_plain(desc_a, valid_a, desc_b, valid_b, max_dist: int = 64):
    """The plain PyTorch version: distances, value*index argmin keys, and
    the mutual test by a gather."""
    P, A, _ = desc_a.shape
    desc_b, valid_b = _expand_b(desc_b, valid_b, P)
    B = desc_b.shape[1]
    dev = desc_a.device
    pair = valid_a[:, :, None] & valid_b[:, None, :]
    dm = torch.where(pair, hamming_plain(desc_a, desc_b).to(torch.int64),
                     torch.full((), BIG, dtype=torch.int64, device=dev))
    rowkey = (dm * B + torch.arange(B, device=dev)).amin(2)       # (P, A)
    colkey = (dm * A + torch.arange(A, device=dev)[:, None]).amin(1)  # (P, B)
    best_b = rowkey % B
    best_d = rowkey // B
    mutual = torch.gather(colkey, 1, best_b) == \
        best_d * A + torch.arange(A, device=dev)
    matched = mutual & (best_d <= max_dist) & (best_d < BIG)
    return best_b.to(torch.int32), matched, best_d.to(torch.int32)


def _check(desc_a, valid_a, desc_b, valid_b):
    if desc_a.dim() != 3 or desc_b.dim() != 3:
        raise ValueError("cross_check takes (P, A, W) and (Q, B, W) "
                         f"descriptors; got {tuple(desc_a.shape)} and "
                         f"{tuple(desc_b.shape)}")
    P, A, W = desc_a.shape
    Q, B, Wb = desc_b.shape
    if W != Wb:
        raise ValueError(f"descriptor widths differ: {W} and {Wb}")
    if Q == 0 or P % Q:
        raise ValueError(f"{P} a-problems do not split over {Q} b-sets")
    if valid_a.shape != (P, A) or valid_b.shape != (Q, B):
        raise ValueError("validity shapes do not match the descriptors")
    if desc_a.dtype != torch.int64 or desc_b.dtype != torch.int64:
        raise TypeError("descriptors are int64 tensors holding uint32 words")
    if valid_a.dtype != torch.bool or valid_b.dtype != torch.bool:
        raise TypeError("validity flags are bool tensors")
    if len({t.device for t in (desc_a, valid_a, desc_b, valid_b)}) != 1:
        raise ValueError("cross_check inputs are on different devices")
    n = max(A, B)
    if BIG * n + n > INT32_MAX:
        raise ValueError(f"cross_check: {n} rows overflow the int32 keys")


def cross_check(desc_a, valid_a, desc_b, valid_b, max_dist: int = 64,
                site: str = "other"):
    """(best_b, matched, best_d), each (P, A), by ``cross_check_plain`` on
    every device (the reference has no kernel)."""
    _check(desc_a, valid_a, desc_b, valid_b)
    return cross_check_plain(desc_a, valid_a, desc_b, valid_b, max_dist)
