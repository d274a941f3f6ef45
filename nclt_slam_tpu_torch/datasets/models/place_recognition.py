"""LiDAR place recognition — the dense-voxel MinkLoc3D counterpart
(``nclt_slam_tpu/datasets/models/place_recognition.py``; the reference's
datasets/nclt_kaggle/src/models/place_recognition.py:24-167).

Each scan is voxelized onto a dense occupancy grid and embedded by a small
3-D conv encoder (three stride-2 blocks), GeM pooling and a linear
projection to 128 dimensions; training uses the triplet margin loss with
batch-hard mining, evaluation Recall@K.

``PRParams`` keeps the JAX package's field names and layouts (DHWIO conv
weights), so ``interop`` carries parameters both ways unchanged; ``embed``
permutes them to torch's OIDHW and the grids to NCDHW.  Parity details:
- SAME padding with stride 2 is asymmetric (JAX pads (0, 1) on an even
  axis), so ``_conv3d`` pads explicitly before an unpadded ``conv3d``;
- ``voxelize`` truncates toward zero (``astype(int32)``), so a point up to
  one cell below ``lo`` lands in cell 0 and counts as inside;
- ties in the batch-hard loss split their gradient evenly (``amax`` /
  ``amin`` / ``maximum``), as JAX's reductions do;
- ``recall_at_k`` ranks with a stable sort over distances formed as a
  difference and a norm, as JAX does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from nclt_slam_tpu_torch.core import prng

VOXEL_GRID = (32, 32, 16)   # x, y, z cells
VOXEL_RANGE = ((-40.0, 40.0), (-40.0, 40.0), (-4.0, 12.0))
EMBED_DIM = 128


def voxelize(pts, valid, grid=VOXEL_GRID, rng=VOXEL_RANGE):
    """Scans (..., N, 3) -> dense occupancy grids (..., X, Y, Z) float32."""
    dev = pts.device
    lo = torch.tensor([r[0] for r in rng], dtype=torch.float32, device=dev)
    hi = torch.tensor([r[1] for r in rng], dtype=torch.float32, device=dev)
    g = torch.tensor(grid, dtype=torch.int32, device=dev)
    cell = ((pts - lo) / (hi - lo) * g.to(torch.float32)).to(torch.int32)
    inside = ((cell >= 0) & (cell < g)).all(-1) & valid
    flat = (cell[..., 0] * grid[1] + cell[..., 1]) * grid[2] + cell[..., 2]
    flat = torch.where(inside, flat, 0).to(torch.int64)
    occ = torch.zeros(pts.shape[:-2] + (grid[0] * grid[1] * grid[2],),
                      dtype=torch.float32, device=dev)
    occ.scatter_reduce_(-1, flat, inside.to(torch.float32), "amax")
    return occ.reshape(pts.shape[:-2] + tuple(grid))


class PRParams(NamedTuple):
    """Conv encoder parameters (3 conv blocks + projection)."""

    w1: torch.Tensor  # (3, 3, 3, 1, 16)   DHWIO
    w2: torch.Tensor  # (3, 3, 3, 16, 32)
    w3: torch.Tensor  # (3, 3, 3, 32, 64)
    proj: torch.Tensor  # (64, EMBED_DIM)
    gem_p: torch.Tensor  # () GeM exponent


def init_params(key) -> PRParams:
    """He-normal conv weights, a 1/sqrt(64) projection, GeM p = 3, drawn
    from ``key`` as the JAX package draws them (on the key's device)."""
    k1, k2, k3, k4 = prng.split(key, 4).unbind(0)

    def scaled_normal(k, shape, var):
        return prng.normal(k, shape) * float(np.sqrt(np.float32(var)))

    def conv_init(k, shape):
        return scaled_normal(k, shape, 2.0 / (shape[0] * shape[1] * shape[2]
                                               * shape[3]))

    return PRParams(
        w1=conv_init(k1, (3, 3, 3, 1, 16)),
        w2=conv_init(k2, (3, 3, 3, 16, 32)),
        w3=conv_init(k3, (3, 3, 3, 32, 64)),
        proj=scaled_normal(k4, (64, EMBED_DIM), 1.0 / 64),
        gem_p=torch.tensor(3.0, dtype=torch.float32, device=key.device),
    )


def _conv3d(x, w, stride):
    """XLA's SAME convolution: x (B, C, X, Y, Z), w DHWIO."""
    pad = []
    for n, k in zip(reversed(x.shape[2:]), reversed(w.shape[:3])):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pad += [total // 2, total - total // 2]
    return F.conv3d(F.pad(x, pad), w.permute(4, 3, 0, 1, 2), stride=stride)


def embed(params: PRParams, grids):
    """Occupancy grids (B, X, Y, Z) -> L2-normalized embeddings (B, D)."""
    x = grids[:, None]                                # (B, 1, X, Y, Z)
    x = torch.relu(_conv3d(x, params.w1, 2))
    x = torch.relu(_conv3d(x, params.w2, 2))
    x = torch.relu(_conv3d(x, params.w3, 2))          # (B, 64, 4, 4, 2)
    # GeM pooling over the spatial dims
    p = torch.maximum(params.gem_p, torch.ones_like(params.gem_p))
    x = torch.maximum(x, torch.full_like(x[:1, :1, :1, :1, :1], 1e-6)) ** p
    x = x.mean(dim=(2, 3, 4)) ** (1.0 / p)            # (B, 64)
    e = x @ params.proj
    return e / (torch.sqrt((e * e).sum(-1, keepdim=True)) + 1e-9)


def triplet_loss_hard(emb, labels, margin: float = 0.5):
    """Batch-hard triplet margin loss (hardest positive + hardest negative
    per anchor, like the reference's hard-mining sampler)."""
    # epsilon inside the sqrt: the self-distance diagonal is masked out
    # below, but the gradient of a norm at exactly 0 is NaN
    d2 = ((emb[:, None] - emb[None, :]) ** 2).sum(-1)
    d = torch.sqrt(d2 + 1e-9)
    same = labels[:, None] == labels[None, :]
    eye = torch.eye(len(labels), dtype=torch.bool, device=emb.device)
    pos = same & ~eye
    neg = ~same
    inf = torch.full_like(d, float("inf"))
    hardest_pos = torch.where(pos, d, -inf).amax(1)
    hardest_neg = torch.where(neg, d, inf).amin(1)
    has_pair = pos.any(1) & neg.any(1)
    hinge = hardest_pos - hardest_neg + margin
    loss = torch.maximum(hinge, torch.zeros_like(hinge))
    return torch.where(has_pair, loss, torch.zeros_like(loss)).mean()


def train_step(params: PRParams, grids, labels, lr: float = 1e-3):
    """One SGD step on the triplet loss; returns (params, loss)."""
    leaves = [p.detach().requires_grad_() for p in params]
    loss = triplet_loss_hard(embed(PRParams(*leaves), grids), labels)
    grads = torch.autograd.grad(loss, leaves)
    new = PRParams(*(p.detach() - lr * g for p, g in zip(leaves, grads)))
    return new, loss.detach()


_QUERY_BLOCK = 256   # queries a distance block: 256 x 2,000 x 128 floats


def recall_at_k(query_emb, db_emb, query_labels, db_labels, k: int = 1):
    """Recall@K retrieval metric (reference eval protocol), over blocks of
    queries."""
    hits = []
    for s in range(0, query_emb.shape[0], _QUERY_BLOCK):
        q = slice(s, s + _QUERY_BLOCK)
        diff = query_emb[q, None] - db_emb[None, :]
        d = torch.sqrt((diff * diff).sum(-1))
        idx = torch.argsort(d, dim=1, stable=True)[:, :k]
        hits.append((db_labels[idx] == query_labels[q, None]).any(1))
    return torch.cat(hits).to(torch.float32).mean()
