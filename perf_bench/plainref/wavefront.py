"""The wavefront (min-plus) relaxation of a batch of cost grids, in plain
PyTorch float32.

``n_iter`` Jacobi sweeps of phi[c] <- min(phi[c], phi[n] + step(n, c))
over the 8 neighbours n of each cell c, all cells updated from the
previous sweep's phi.  A step into c costs tc[c] from an edge neighbour
and tc[c] * 1.4142135 (rounded to float32 once) from a corner neighbour;
cells beyond the grid read phi = 1e9.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

OUTSIDE = 1e9
DIAGONAL = 1.4142135


def relax(tc, phi0, n_iter: int):
    H, W = tc.shape[-2:]
    corner = tc * DIAGONAL
    phi = phi0.clone()
    for _ in range(n_iter):
        p = F.pad(phi, (1, 1, 1, 1), value=OUTSIDE)
        best = phi
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                if dr == dc == 0:
                    continue
                step = corner if dr and dc else tc
                n = p[:, 1 + dr:1 + dr + H, 1 + dc:1 + dc + W]
                best = torch.minimum(best, n + step)
        phi = best
    return phi
