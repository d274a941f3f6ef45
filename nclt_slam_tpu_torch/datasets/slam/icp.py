"""LiDAR ICP odometry (``nclt_slam_tpu/datasets/slam/icp.py``).

Point-to-point and point-to-plane ICP with fixed iteration counts and
brute-force nearest neighbours (a dense distance matrix), wheel-odometry
prediction as the initial guess, a sliding local map of the last scans, and
RANSAC ground removal.  Everything is fixed-shape; a session's loop over
scans runs without a host synchronization (``pipeline.py``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from nclt_slam_tpu_torch.core import prng


class ICPResult(NamedTuple):
    R: torch.Tensor          # (3, 3)
    t: torch.Tensor          # (3,)
    rmse: torch.Tensor       # () inlier RMSE
    n_inliers: torch.Tensor  # () int32


def _sq_dists(src, dst):
    """Squared distances (N, M) of every src point to every dst point, as
    the difference of coordinates squared and summed in x, y, z order (the
    JAX package's ``((src[:, None] - dst[None]) ** 2).sum(-1)``, without
    its (N, M, 3) intermediate)."""
    s, d = src.T.contiguous(), dst.T.contiguous()
    d2 = s[0, :, None] - d[0]
    d2.mul_(d2)
    for c in (1, 2):
        e = s[c, :, None] - d[c]
        d2 += e.mul_(e)
    return d2


def _nearest(src, dst, dst_valid):
    """Brute-force NN: for each src point the nearest valid dst point.

    src (N, 3), dst (M, 3) -> (idx (N,), dist (N,)); ties go to the first
    index."""
    # + inf on the invalid columns, + 0 (exact) on the valid ones
    d2 = _sq_dists(src, dst).add_(torch.where(dst_valid, 0.0, math.inf))
    best = d2.min(dim=1)
    return best.indices, torch.sqrt(best.values)


def _det3(M):
    """Determinant of (..., 3, 3) matrices by cofactors."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2]
                            - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2]
                              - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1]
                              - M[..., 1, 1] * M[..., 2, 0]))


def _kabsch_weighted(P, Q, w):
    """Weighted rigid fit Q ~ R P + t.  P, Q (..., N, 3), w (..., N) ->
    (R (..., 3, 3), t (..., 3)).  R = V diag(1, 1, sign det(V U^T)) U^T is
    unique for a cross-covariance of rank >= 2, whatever signs the SVD
    gives its singular vectors."""
    wsum = w.sum(-1).clamp_min(1e-6)[..., None]
    mp = (P * w[..., None]).sum(-2) / wsum
    mq = (Q * w[..., None]).sum(-2) / wsum
    H = ((P - mp[..., None, :]) * w[..., None]).transpose(-1, -2) \
        @ (Q - mq[..., None, :])
    U, _, Vh = torch.linalg.svd(H)
    V = Vh.transpose(-1, -2)
    d = torch.sign(_det3(V @ U.transpose(-1, -2)))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d),
                                      d], -1))
    R = V @ D @ U.transpose(-1, -2)
    return R, mq - (R @ mp[..., None])[..., 0]


def _eye_zero(src, R0, t0):
    R = torch.eye(3, dtype=src.dtype, device=src.device) if R0 is None \
        else R0
    t = src.new_zeros(3) if t0 is None else t0
    return R, t


def _result(R, t, dist, w):
    n_inl = w.sum()
    rmse = torch.sqrt((w * dist ** 2).sum() / n_inl.clamp_min(1.0))
    return ICPResult(R=R, t=t, rmse=rmse, n_inliers=n_inl.to(torch.int32))


def icp_point_to_point(src, src_valid, dst, dst_valid, R0=None, t0=None,
                       iters: int = 20, max_corr: float = 1.0) -> ICPResult:
    """Point-to-point ICP src->dst with fixed iterations.

    src/dst: (N, 3)/(M, 3) padded tensors with validity masks.  R0/t0: the
    initial guess (e.g. the wheel-odometry prediction).  The RMSE and the
    inlier count are those of the last iteration's correspondences."""
    R, t = _eye_zero(src, R0, t0)
    for _ in range(iters):
        moved = src @ R.T + t
        idx, dist = _nearest(moved, dst, dst_valid)
        w = (src_valid & (dist < max_corr)).to(src.dtype)
        R, t = _kabsch_weighted(src, dst[idx], w)
    return _result(R, t, dist, w)


def _rodrigues(w):
    th = torch.linalg.vector_norm(w) + 1e-12
    k = w / th
    z = torch.zeros_like(k[0])
    K = torch.stack([torch.stack([z, -k[2], k[1]]),
                     torch.stack([k[2], z, -k[0]]),
                     torch.stack([-k[1], k[0], z])])
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + torch.sin(th) * K + (1 - torch.cos(th)) * (K @ K)


def icp_point_to_plane(src, src_valid, dst, dst_normals, dst_valid,
                       R0=None, t0=None, iters: int = 15,
                       max_corr: float = 1.0) -> ICPResult:
    """Point-to-plane ICP via small-angle linearization (6x6 solve an
    iteration)."""
    R, t = _eye_zero(src, R0, t0)
    eye6 = torch.eye(6, dtype=src.dtype, device=src.device)
    for _ in range(iters):
        moved = src @ R.T + t
        idx, dist = _nearest(moved, dst, dst_valid)
        q = dst[idx]
        n = dst_normals[idx]
        w = (src_valid & (dist < max_corr)).to(src.dtype)
        r = ((moved - q) * n).sum(-1)
        J = torch.cat([torch.linalg.cross(moved, n, dim=-1), n], -1)
        Jw = J * w[:, None]
        H = Jw.T @ J + 1e-6 * eye6
        g = Jw.T @ r
        dx = -torch.linalg.solve(H, g)
        dR = _rodrigues(dx[:3])
        R, t = dR @ R, dR @ t + dx[3:]
    return _result(R, t, dist, w)


def remove_ground_ransac(pts, valid, key, iters: int = 64,
                         dist_thresh: float = 0.25):
    """RANSAC plane fit + removal over ``iters`` 3-point hypotheses drawn
    from ``key`` (``core/prng``, JAX's threefry draws); the most supported
    near-horizontal plane is the ground.  Returns (validity with the ground
    removed, normal, offset)."""
    N = pts.shape[0]
    idx = prng.randint(key, (iters, 3), 0, N).long()
    p0, p1, p2 = pts[idx[:, 0]], pts[idx[:, 1]], pts[idx[:, 2]]
    n = torch.linalg.cross(p1 - p0, p2 - p0, dim=-1)
    ns = n / (torch.linalg.vector_norm(n, dim=-1, keepdim=True) + 1e-9)
    ds = (ns * p0).sum(-1)
    dist = (pts @ ns.T - ds[None, :]).abs().T              # (iters, N)
    inl = (dist < dist_thresh) & valid[None, :]
    score = inl.sum(-1) * (ns[:, 2].abs() > 0.8)
    best = torch.argmax(score)
    return valid & ~inl[best], ns[best], ds[best]


class LocalMap(NamedTuple):
    """Sliding local map of the last S scans (a ring)."""

    pts: torch.Tensor      # (S, N, 3) scans in the world frame
    valid: torch.Tensor    # (S, N)
    cursor: torch.Tensor   # () int32


def init_local_map(n_scans: int, pts_per_scan: int, device) -> LocalMap:
    return LocalMap(
        pts=torch.zeros(n_scans, pts_per_scan, 3, device=device),
        valid=torch.zeros(n_scans, pts_per_scan, dtype=torch.bool,
                          device=device),
        cursor=torch.zeros((), dtype=torch.int32, device=device))


def local_map_insert(m: LocalMap, scan_world, scan_valid) -> LocalMap:
    """The map with ``scan_world`` in the oldest slot (out of place, with
    no host synchronization)."""
    slot = (m.cursor % m.pts.shape[0]).long().reshape(1)
    return LocalMap(pts=m.pts.index_copy(0, slot, scan_world[None]),
                    valid=m.valid.index_copy(0, slot, scan_valid[None]),
                    cursor=m.cursor + 1)


def local_map_flat(m: LocalMap):
    S, N, _ = m.pts.shape
    return m.pts.reshape(S * N, 3), m.valid.reshape(S * N)
