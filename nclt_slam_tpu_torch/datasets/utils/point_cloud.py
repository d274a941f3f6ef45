"""Point-cloud utilities (datasets/nclt_kaggle/src/utils/point_cloud.py;
``nclt_slam_tpu/datasets/utils/point_cloud.py``): fixed-shape voxel
downsampling, transforms, cropping and k-NN normals on tensors.

``voxel_downsample`` reproduces the JAX package's results bit for bit,
quirks included: its ``jnp.int64`` voxel hash is int32 with x64 off, so the
hash wraps once ``dims**3`` passes 2**31 (a voxel finer than ~0.31 m at
``bound=200``) and a wrapped negative hash is dropped like an invalid
point; and every row that is not kept, with every kept row of rank
``out_cap - 1`` or more, writes slot ``out_cap - 1``, where XLA's CPU
scatter lets the last such row win.
"""

from __future__ import annotations

import torch

from nclt_slam_tpu_torch.datasets.slam.loop_closure import _set_last


def transform_points(pts, T):
    """Apply 4x4 transform to (N, 3) points."""
    return pts @ T[:3, :3].T + T[:3, 3]


def voxel_downsample(pts, valid, voxel: float, out_cap: int,
                     bound: float = 200.0):
    """Fixed-shape voxel-grid downsample: keep (up to ``out_cap``) the first
    valid point of each occupied voxel.  Deterministic."""
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, which rounds some quotients differently
    size = torch.tensor(voxel, dtype=pts.dtype, device=pts.device)
    key_int = torch.floor((pts + bound) / size).to(torch.int32)
    dims = int(2 * bound / voxel) + 1
    # int32 arithmetic wraps like XLA's (the JAX package's int64 is int32)
    h = (key_int[:, 0] * dims + key_int[:, 1]) * dims + key_int[:, 2]
    h = torch.where(valid, h, torch.full_like(h, -1))
    order = torch.argsort(h, stable=True)
    h_sorted = h[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=h.device),
                       h_sorted[1:] != h_sorted[:-1]])
    keep = first & (h_sorted >= 0)
    # compact kept points to the front, pad with zeros
    rank = torch.cumsum(keep.to(torch.int32), 0) - 1
    last = out_cap - 1
    write_idx = torch.where(keep, torch.clamp_max(rank, last),
                            torch.full_like(rank, last)).to(torch.int64)
    src = pts[order]
    out = _set_last(torch.zeros(out_cap, 3, dtype=pts.dtype,
                                device=pts.device), write_idx,
                    torch.where(keep[:, None], src, torch.zeros_like(src)))
    out_valid = torch.zeros(out_cap, dtype=torch.uint8, device=pts.device)
    out_valid = out_valid.scatter_reduce(0, write_idx, keep.to(torch.uint8),
                                         "amax")
    return out, out_valid.bool()


def crop_box(pts, valid, lo, hi):
    """Validity mask restricted to an axis-aligned box."""
    lo = torch.as_tensor(lo, dtype=pts.dtype, device=pts.device)
    hi = torch.as_tensor(hi, dtype=pts.dtype, device=pts.device)
    inside = ((pts >= lo) & (pts <= hi)).all(-1)
    return valid & inside


def estimate_normals_knn(pts, valid, k: int = 8):
    """Per-point normals from the k-NN covariance (brute-force neighbors,
    fixed shapes) — feeds point-to-plane ICP.  Neighbours in a stable
    ascending order of distance (``jnp.argsort``'s); an eigenvector's sign
    is the library's, so a normal with n_z = 0 may come out negated."""
    d2 = ((pts[:, None] - pts[None, :]) ** 2).sum(-1)
    d2 = torch.where(valid[None, :], d2, torch.full_like(d2, float("inf")))
    idx = torch.argsort(d2, dim=1, stable=True)[:, :k]     # (N, k)
    nbrs = pts[idx]                                        # (N, k, 3)
    mu = nbrs.mean(1, keepdim=True)
    c = nbrs - mu
    C = torch.einsum("nki,nkj->nij", c, c) / k
    _, v = torch.linalg.eigh(C)
    n = v[..., 0]                                          # smallest
    # orient upward-ish for determinism
    return n * torch.where(n[:, 2:3] < 0, -1.0, 1.0)
