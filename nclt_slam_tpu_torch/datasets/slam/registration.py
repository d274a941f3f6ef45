"""Global registration for loop-closure candidates: FPFH + RANSAC + ICP
(``nclt_slam_tpu/datasets/slam/registration.py``).

Normals from dense k-NN covariance eigenvectors, a simplified FPFH
(Darboux-angle histograms over the k-NN graph, SPFH + neighbour-weighted
sum), feature correspondences as one dense descriptor-similarity product,
and Kabsch over a batch of 3-point RANSAC hypotheses drawn with JAX's
threefry (``core/prng``), so that a key gives the JAX package's picks.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from nclt_slam_tpu_torch.core import prng
from nclt_slam_tpu_torch.datasets.slam.icp import (
    _kabsch_weighted,
    _sq_dists,
    icp_point_to_point,
)

FPFH_BINS = 11          # bins per Darboux angle -> 33-dim descriptor
K_NEIGHBORS = 16
BIG = 1e12


def _knn(pts, valid, k: int):
    """Dense k-NN: (N, k) neighbour indices + validity (self excluded);
    equal distances in index order (JAX's stable argsort)."""
    d2 = torch.where(valid[None, :], _sq_dists(pts, pts), BIG)
    d2.diagonal().add_(BIG)                        # exclude self
    idx = torch.argsort(d2, dim=1, stable=True)[:, :k]
    ok = d2.gather(1, idx) < BIG / 2
    return idx, ok


def _normals(pts, idx, ok):
    nb = pts[idx]                                   # (N, k, 3)
    w = ok.to(pts.dtype)[..., None]
    cnt = w.sum(1).clamp_min(1.0)
    mean = (nb * w).sum(1) / cnt
    d = (nb - mean[:, None, :]) * w
    cov = d.transpose(1, 2) @ d / cnt[..., None]
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device)
    # eigh returns ascending eigenvalues: normal = first eigenvector
    n = torch.linalg.eigh(cov + 1e-9 * eye).eigenvectors[:, :, 0]
    # orient towards the sensor origin (the eigenvector's sign is arbitrary)
    flip = (n * pts).sum(-1) > 0
    return torch.where(flip[:, None], -n, n)


def estimate_normals(pts, valid, k: int = K_NEIGHBORS):
    """Per-point normal = smallest eigenvector of the k-NN covariance."""
    idx, ok = _knn(pts, valid, k)
    return _normals(pts, idx, ok)


def _spfh(pts, normals, idx, ok):
    """Simplified point feature histogram per point: histograms of the
    Darboux angles (alpha, phi, theta) between each point and its k-NN."""
    p = pts[:, None, :]                              # (N, 1, 3)
    q = pts[idx]                                     # (N, k, 3)
    n_q = normals[idx]
    u = normals[:, None, :].expand_as(q)

    d = q - p
    dist = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    d_hat = d / dist.clamp_min(1e-9)
    v = torch.linalg.cross(d_hat, u, dim=-1)
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(1e-9)
    w = torch.linalg.cross(u, v, dim=-1)

    alpha = (v * n_q).sum(-1)                        # [-1, 1]
    phi = (u * d_hat).sum(-1)                        # [-1, 1]
    theta = torch.atan2((w * n_q).sum(-1), (u * n_q).sum(-1))

    def hist(x, lo, hi):
        bins = torch.floor((x - lo) / (hi - lo) * FPFH_BINS)
        bins = bins.clamp(0, FPFH_BINS - 1).long()
        onehot = F.one_hot(bins, FPFH_BINS).to(pts.dtype) * ok[..., None]
        return onehot.sum(1)                         # (N, FPFH_BINS)

    h = torch.cat([hist(alpha, -1.0, 1.0), hist(phi, -1.0, 1.0),
                   hist(theta, -math.pi, math.pi)], -1)    # (N, 33)
    return h / h.sum(-1, keepdim=True).clamp_min(1e-9)


def fpfh(pts, valid, k: int = K_NEIGHBORS):
    """FPFH descriptor (N, 33): SPFH + distance-weighted neighbour SPFH.
    (The JAX package computes the k-NN a second time inside
    ``estimate_normals``; it is the same graph.)"""
    idx, ok = _knn(pts, valid, k)
    s = _spfh(pts, _normals(pts, idx, ok), idx, ok)
    d = torch.linalg.vector_norm(pts[idx] - pts[:, None, :], dim=-1)
    w = ok.to(pts.dtype) / d.clamp_min(0.05)
    nb = (s[idx] * w[..., None]).sum(1) / w.sum(1, keepdim=True) \
        .clamp_min(1e-9)
    f = s + nb
    return f / torch.linalg.vector_norm(f, dim=-1, keepdim=True) \
        .clamp_min(1e-9)


class RegistrationResult(NamedTuple):
    R: torch.Tensor          # (3, 3)
    t: torch.Tensor          # (3,)
    n_inliers: torch.Tensor  # () RANSAC consensus
    rmse: torch.Tensor       # () refined ICP rmse
    ok: torch.Tensor         # () bool — the acceptance gate


def fpfh_correspondences(src, src_valid, dst, dst_valid,
                         k: int = K_NEIGHBORS):
    """Each src point's FPFH nearest neighbour in dst (one dense
    descriptor-similarity product; the first of equal similarities wins):
    (corr (N,) indices into dst, corr_ok (N,) bool)."""
    sim = fpfh(src, src_valid, k) @ fpfh(dst, dst_valid, k).T
    sim = torch.where(src_valid[:, None] & dst_valid[None, :], sim, -1e9)
    corr = torch.argmax(sim, dim=1)                  # (N,) src -> dst
    corr_ok = src_valid & (sim.gather(1, corr[:, None])[:, 0] > -1e8)
    return corr, corr_ok


def ransac_hypotheses(src, Q, corr_ok, key, iters: int = 256,
                      inlier_thresh: float = 0.75):
    """``iters`` 3-point Kabsch hypotheses on the correspondences src -> Q,
    the picks drawn with ``prng.randint``, and each one's consensus (the
    valid correspondences it moves within ``inlier_thresh``): (Rs, ts,
    counts, picks)."""
    picks = prng.randint(key, (iters, 3), 0, src.shape[0]).long()
    w3 = corr_ok[picks].to(src.dtype)
    Rs, ts = _kabsch_weighted(src[picks], Q[picks], w3 + 1e-3)
    moved = src[None] @ Rs.transpose(1, 2) + ts[:, None, :]
    resid = torch.linalg.vector_norm(moved - Q[None], dim=-1)
    counts = ((resid < inlier_thresh) & corr_ok[None]).sum(-1)
    return Rs, ts, counts, picks


def ransac_registration(src, src_valid, dst, dst_valid, key,
                        k: int = K_NEIGHBORS, iters: int = 256,
                        inlier_thresh: float = 0.75,
                        min_inlier_frac: float = 0.25):
    """FPFH-correspondence RANSAC: dense feature NN src->dst, a batch of
    3-point Kabsch hypotheses, consensus on correspondence distance.
    Returns (R, t, n_inliers, ok); the first best hypothesis wins."""
    corr, corr_ok = fpfh_correspondences(src, src_valid, dst, dst_valid, k)
    Rs, ts, counts, _ = ransac_hypotheses(src, dst[corr], corr_ok, key,
                                          iters, inlier_thresh)
    best = torch.argmax(counts)
    n_inl = counts[best]
    need = (min_inlier_frac * corr_ok.sum()).to(torch.int32).clamp_min(10)
    return Rs[best], ts[best], n_inl, n_inl >= need


def refine_and_gate(src, src_valid, dst, dst_valid, R0, t0, n_inl, ok,
                    icp_iters: int = 20, max_corr: float = 1.0,
                    fitness_min: float = 0.55) -> RegistrationResult:
    """``register_loop``'s second half: point-to-point ICP refinement from
    a RANSAC result (R0, t0, its consensus n_inl and flag ok), then the
    acceptance gate: the RANSAC consensus or the refined ICP's fitness
    (share of valid src points with a correspondence within max_corr)
    passes, and the refined RMSE is below 0.6 max_corr."""
    res = icp_point_to_point(src, src_valid, dst, dst_valid,
                             R0=R0, t0=t0, iters=icp_iters,
                             max_corr=max_corr)
    fitness = res.n_inliers.to(src.dtype) / \
        src_valid.sum().to(src.dtype).clamp_min(1.0)
    accept = (ok | (fitness >= fitness_min)) & (res.rmse < 0.6 * max_corr)
    return RegistrationResult(R=res.R, t=res.t, n_inliers=n_inl,
                              rmse=res.rmse, ok=accept)


def register_loop(src, src_valid, dst, dst_valid, key,
                  ransac_iters: int = 256, icp_iters: int = 20,
                  max_corr: float = 1.0,
                  fitness_min: float = 0.55) -> RegistrationResult:
    """Loop-candidate registration: FPFH-RANSAC global alignment, then
    ``refine_and_gate``."""
    R0, t0, n_inl, ok = ransac_registration(
        src, src_valid, dst, dst_valid, key, iters=ransac_iters)
    return refine_and_gate(src, src_valid, dst, dst_valid, R0, t0, n_inl, ok,
                           icp_iters=icp_iters, max_corr=max_corr,
                           fitness_min=fitness_min)
