"""Wavefront potential relaxation, plain PyTorch only.

``wavefront_relax(tc, phi0, n_iter)`` runs ``n_iter`` Jacobi iterations of

    phi <- min(phi, min over 8 neighbours n of phi[n] + s_n * tc)

on a batch of (H, W) grids, where ``tc`` is the receiving cell's traversal
cost, s_n is 1 (orthogonal) or 1.4142135 (diagonal, ``tc * 1.4142135``
rounded once, then added), and cells outside the grid read as BIG = 1e9.
The reference's stand-in for the port's kernel K2.
"""

from __future__ import annotations

import torch

BIG = 1e9
DIAG = 1.4142135

def _shift(a, dr: int, dc: int):
    """a shifted by (dr, dc) over the last two dims, the wrapped edge
    poisoned with BIG (``planning/wavefront.py:_neighbor_min``)."""
    a = torch.roll(a, (dr, dc), (-2, -1))
    if dr == 1:
        a[..., 0, :] = BIG
    elif dr == -1:
        a[..., -1, :] = BIG
    if dc == 1:
        a[..., :, 0] = BIG
    elif dc == -1:
        a[..., :, -1] = BIG
    return a


def neighbor_min(phi, tc, diag_scale: float = DIAG):
    """One relaxation sweep: min of phi and, over the 8 neighbours, the
    neighbour's phi plus the step cost into this cell."""
    best = phi
    for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        best = torch.minimum(best, _shift(phi, dr, dc) + tc)
    tcd = tc * diag_scale
    for dr, dc in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
        best = torch.minimum(best, _shift(phi, dr, dc) + tcd)
    return best


def wavefront_relax_plain(tc, phi0, n_iter: int):
    """The plain PyTorch relaxation: ``n_iter`` Jacobi sweeps."""
    phi = phi0
    for _ in range(n_iter):
        phi = torch.minimum(phi, neighbor_min(phi, tc))
    return phi


def _check(tc, phi0, n_iter):
    if tc.shape != phi0.shape or tc.dim() != 3:
        raise ValueError(f"tc and phi0 must both be (B, H, W); got "
                         f"{tuple(tc.shape)} and {tuple(phi0.shape)}")
    if tc.dtype != torch.float32 or phi0.dtype != torch.float32:
        raise TypeError("wavefront_relax takes float32 tensors")
    if tc.device != phi0.device:
        raise ValueError("tc and phi0 are on different devices")
    if not (tc.is_contiguous() and phi0.is_contiguous()):
        raise ValueError("wavefront_relax takes contiguous tensors")
    if n_iter < 0:
        raise ValueError("n_iter must be >= 0")


def wavefront_relax(tc, phi0, n_iter: int):
    """Relaxed potential (B, H, W) from costs ``tc`` and seed ``phi0`` by
    ``wavefront_relax_plain`` on every device (the reference has no
    kernel)."""
    _check(tc, phi0, n_iter)
    return wavefront_relax_plain(tc, phi0, n_iter)
