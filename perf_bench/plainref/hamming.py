"""Mutual-nearest-neighbour matching of binary descriptors by Hamming
distance, in plain PyTorch.

Problem p matches its a-rows (A, W words of 32 bits) against b-set
``p // (P // Q)`` (B rows).  The distance of two rows is the number of
differing bits, here counted from the unpacked bits with float64 matrix
products (exact: at most 32 W).  A pair in which either row is invalid is
no candidate.  Each a-row's best b is the nearest candidate, the lowest
index among equals; an a-row with no candidate gets b = 0 and the
distance ``BIG``.  An a-row is matched when its best b's nearest a-row,
again the lowest index among equals, is that a-row and the distance is at
most ``max_dist``.
"""

from __future__ import annotations

import torch

BIG = 10 ** 6


def _bits(desc):
    """(N, R, W) int64 words in [0, 2**32) -> (N, R, 32 W) float64 bits."""
    shifts = torch.arange(32, device=desc.device)
    b = (desc[..., None] >> shifts) & 1
    return b.reshape(*desc.shape[:-1], -1).to(torch.float64)


def cross_check(desc_a, valid_a, desc_b, valid_b, max_dist: int):
    """(best_b int64, matched bool, best_d int64), each (P, A)."""
    P, A, _ = desc_a.shape
    group = P // desc_b.shape[0]
    a = _bits(desc_a)
    b = _bits(desc_b).repeat_interleave(group, 0)
    vb = valid_b.repeat_interleave(group, 0)
    d = a @ (1.0 - b).transpose(1, 2) + (1.0 - a) @ b.transpose(1, 2)
    d = d.round().to(torch.int64)
    pair = valid_a[:, :, None] & vb[:, None, :]
    d = torch.where(pair, d, torch.full_like(d, BIG))
    best_d, best_b = d.min(2)                 # first index among equals
    best_a = d.argmin(1)                      # (P, B)
    mutual = torch.gather(best_a, 1, best_b) == \
        torch.arange(A, device=d.device)
    any_pair = pair.any(2)
    best_b = torch.where(any_pair, best_b, torch.zeros_like(best_b))
    matched = mutual & any_pair & (best_d <= max_dist)
    return best_b, matched, best_d
