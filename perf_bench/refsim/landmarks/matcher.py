"""Repeat-time visual anchor matcher (``nclt_slam_tpu/landmarks/matcher.py``).

2 Hz anchor attempts: pick teach landmarks within 8 m of the query pose with
heading within 90° (top-5 by distance), match descriptors with a mutual
cross-check (kernel K1, all routes x candidates in one launch), solve the
relative camera pose teach->live with batched RANSAC (3-point Kabsch
hypotheses scored by 2-D reprojection), apply the reference's gates
(>= 10 matches, >= 10 inliers, median reprojection <= 2 px), compose the
anchor pose through the teach camera's world pose, add the aliased-anchor
bias model, reject anchors > 5 m from the query, and map the inlier count to
an anchor std.  Every tensor carries a leading route dimension; the
candidates are a second batch dimension where the JAX package vmaps.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from refsim.config import CameraConfig, LandmarkConfig
from refsim.core import ordered, prng
from refsim.core.quat import quat_to_mat
from refsim.landmarks.store import LandmarkStore
from refsim.sensors.depth import R_BASE_CAM
from refsim.sensors.features import (
    Observation,
    _bias_field,
    _pymod,
    cross_check_match,
)


class AnchorResult(NamedTuple):
    xy: torch.Tensor        # (B, 2) anchor base position (world)
    std: torch.Tensor       # (B,)
    ok: torch.Tensor        # (B,) bool — published
    n_inliers: torch.Tensor  # (B,) int32
    reproj: torch.Tensor    # (B,)
    reason: torch.Tensor    # (B,) int32 outcome code


# outcome codes (anchor_matches.csv 'outcome' column equivalents)
R_PUBLISHED = 0
R_NO_CANDIDATES = 1
R_NO_FEATURES = 2
R_NO_PNP_ACCEPT = 3
R_CONSISTENCY_FAIL = 4

_POWER_ITERS = 24


def _horn_starts(P, Q, w):
    """Horn's quaternion method short of its choice of start: the weighted
    centroids mp, mq (..., 1, 3), the four starts after the power iteration
    V (..., 4, 4) (one a column, rows w x y z) and their Rayleigh quotients
    (..., 4).  In the dtype of P.

    Every sum is in a fixed order (``core/ordered.py``): over the points
    by a pairwise tree, over the 4 x 4 algebra left to right in the JAX
    package's order (its unrolled Python sums: the power step over j, the
    norm over i, the Rayleigh quotient's 16 terms ``(V[i] * N[i][j]) *
    V[j]`` i-major), so a row's result does not depend on the rows beside
    it."""
    w = w[..., None]
    wsum = ordered.tree_sum(w, -2).clamp_min(1e-6)
    mp = ordered.tree_sum(P * w, -2) / wsum                 # (..., 1, 3)
    mq = ordered.tree_sum(Q * w, -2) / wsum
    X, Y = (P - mp) * w, Q - mq
    H = ordered.tree_sum(X[..., :, None] * Y[..., None, :], -3)[..., 0, :, :]
    sxx, sxy, sxz = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    syx, syy, syz = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    szx, szy, szz = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    shift = 2.0 * ordered.sqrt(ordered.seq_sum((H * H).flatten(-2), -1)) \
        + 1e-6
    Nm = torch.stack([
        sxx + syy + szz + shift, syz - szy, szx - sxz, sxy - syx,
        syz - szy, sxx - syy - szz + shift, sxy + syx, szx + sxz,
        szx - sxz, sxy + syx, -sxx + syy - szz + shift, syz + szy,
        sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz + shift,
    ], -1).reshape(H.shape[:-2] + (4, 4))
    eye = torch.eye(4, dtype=torch.bool, device=H.device)
    V = torch.where(eye, torch.tensor(1.05, dtype=H.dtype, device=H.device),
                    torch.tensor(0.05, dtype=H.dtype, device=H.device))
    V = V.expand(Nm.shape)
    for _ in range(_POWER_ITERS):
        V2 = ordered.mm(Nm, V)
        nrm = ordered.sqrt(ordered.seq_sum(V2 * V2, -2)[..., None, :])
        V = V2 / (nrm + 1e-12)
    terms = V[..., :, None, :] * Nm[..., :, :, None] * V[..., None, :, :]
    rayleigh = ordered.seq_sum(terms.flatten(-3, -2), -2)   # (..., 4)
    return V, rayleigh, mp, mq


def _start_pose(V, k, mp, mq):
    """R, t of start ``k`` (...,) of ``_horn_starts``."""
    v = torch.gather(V, -1, k[..., None, None].expand(
        k.shape + (4, 1)))[..., 0]                         # (..., 4) wxyz
    R = quat_to_mat(torch.stack([v[..., 1], v[..., 2], v[..., 3],
                                 v[..., 0]], -1))
    t = mq[..., 0, :] - ordered.mm(R, mp[..., 0, :, None])[..., 0]
    return R, t


def _kabsch(P, Q, w):
    """Weighted rigid alignment R, t with R @ P + t ~= Q.
    P, Q (..., N, 3), w (..., N).

    Horn's quaternion method: the dominant eigenvector of the 4x4 N matrix
    by a fixed 24-step power iteration from all four basis starts, the one
    with the largest Rayleigh quotient kept — the JAX package's algorithm,
    with the 4x4 algebra as broadcast (..., 4, 4) products summed in its
    order (``_horn_starts``)."""
    V, rayleigh, mp, mq = _horn_starts(P, Q, w)
    return _start_pose(V, rayleigh.argmax(-1), mp, mq)


def _project(p_cam, cam: CameraConfig):
    z = p_cam[..., 2].clamp_min(1e-6)
    return torch.stack([cam.fx * p_cam[..., 0] / z + cam.cx,
                        cam.fy * p_cam[..., 1] / z + cam.cy], -1)


def _take_last(x, idx):
    """Gather along the second-to-last batch axis: x (..., F, D...) at idx
    (..., H) over the F axis, for any number of leading dims."""
    lead = idx.dim() - 1
    flat = x.reshape((-1,) + x.shape[lead:])
    fi = idx.reshape(-1, idx.shape[-1])
    out = flat[torch.arange(flat.shape[0], device=x.device)[:, None], fi]
    return out.reshape(idx.shape + x.shape[lead + 1:])


def ransac_samples(p3d_teach, p3d_live, pair_valid, key,
                   cfg: LandmarkConfig):
    """RANSAC's minimal sets: ``cfg.ransac_iterations`` 3-point samples of
    the matched pairs, (teach, live) points (..., H, 3, 3), whether each
    is a valid hypothesis (..., H) and the number of matched pairs (...,)."""
    Hn = cfg.ransac_iterations
    # minimal sets from the compacted matched pool (matched indices first)
    pool = torch.sort((~pair_valid).to(torch.uint8), dim=-1, stable=True).indices
    n_pairs = pair_valid.sum(-1)
    j = prng.randint(key, (Hn, 3), 0, n_pairs.clamp_min(1)).long()
    idx = torch.gather(pool, -1, j.reshape(j.shape[:-2] + (-1,))).reshape(
        j.shape)                                           # (..., H, 3)
    distinct = (j[..., 0] != j[..., 1]) & (j[..., 1] != j[..., 2]) & \
        (j[..., 0] != j[..., 2])
    hyp_ok = distinct & (n_pairs >= 3)[..., None]

    flat = idx.reshape(idx.shape[:-2] + (-1,))
    Pt = _take_last(p3d_teach, flat).reshape(idx.shape + (3,))
    Pl = _take_last(p3d_live, flat).reshape(idx.shape + (3,))
    return Pt, Pl, hyp_ok, n_pairs


def ransac_pose(p3d_teach, uv_live, p3d_live, pair_valid, key,
                cam: CameraConfig, cfg: LandmarkConfig):
    """RANSAC T_live_teach from matched (teach 3-D, live 2-D/3-D) pairs,
    batched over the leading dims of ``pair_valid`` (..., F); ``key``
    (..., 2).  Returns (R, t, n_inliers, median_reproj, ok)."""
    Pt, Pl, hyp_ok, n_pairs = ransac_samples(p3d_teach, p3d_live,
                                             pair_valid, key, cfg)
    Rs, ts = _kabsch(Pt, Pl, torch.ones(Pt.shape[:-1], device=Pt.device))

    # score every hypothesis by the reprojection of ALL teach points
    pred = torch.matmul(p3d_teach[..., None, :, :],
                        Rs.transpose(-1, -2)) + ts[..., None, :]  # (..,H,F,3)
    err = torch.linalg.vector_norm(_project(pred, cam)
                                   - uv_live[..., None, :, :], dim=-1)
    inl = (err < cfg.ransac_reproj_px) & pair_valid[..., None, :]
    n_inl = torch.where(hyp_ok, inl.sum(-1), torch.full_like(n_pairs[..., None], -1))
    best = n_inl.argmax(-1)

    # refine on the best hypothesis' inliers
    w = torch.gather(inl, -2, best[..., None, None].expand(
        best.shape + (1, inl.shape[-1])))[..., 0, :].to(torch.float32)
    R_ref, t_ref = _kabsch(p3d_teach, p3d_live, w)
    pred = torch.matmul(p3d_teach, R_ref.transpose(-1, -2)) + t_ref[..., None, :]
    err = torch.linalg.vector_norm(_project(pred, cam) - uv_live, dim=-1)
    inl_f = (err < cfg.ransac_reproj_px) & pair_valid
    n_f = inl_f.sum(-1)

    # median reprojection over the final inliers
    err_sorted = torch.sort(torch.where(inl_f, err, torch.full_like(
        err, float("inf"))), -1).values
    med = torch.gather(err_sorted, -1, ((n_f - 1) // 2).clamp_min(0)[
        ..., None])[..., 0]
    best_n = torch.gather(n_inl, -1, best[..., None])[..., 0]
    ok = (n_f >= cfg.min_inliers) & (med <= cfg.reproj_max_px) & (best_n > 0)
    return R_ref, t_ref, n_f.to(torch.int32), med, ok


def _f32(x: float) -> float:
    """A constant as float32 rounds it (the JAX package's weak-typed
    scalars are float32)."""
    return float(np.float32(x))


def sample_anchor_bias(lm_xy, key, cfg: LandmarkConfig):
    """Published-anchor error vector (LandmarkConfig.anchor_bias_*): a
    smooth per-landmark field for direction and dominant magnitude, a
    per-attempt lognormal/direction jitter, and an i.i.d. gross-mismatch
    tail.  lm_xy (B, 2), key (B, 2) -> (B, 2)."""
    k_j, k_dj, k_g, k_gm = prng.split(key, 4).unbind(-2)
    s = cfg.anchor_bias_scale_m
    x, y = lm_xy[..., 0], lm_xy[..., 1]
    fx = _bias_field(x, y, s, (0.7, 2.9, 4.1))
    fy = _bias_field(x, y, s, (1.9, 3.1, 5.9))
    fm = _bias_field(x, y, s, (2.3, 0.4, 3.7))
    f32 = np.float32
    sigma_tot = np.log(f32(cfg.anchor_bias_p90_m / cfg.anchor_bias_median_m)) \
        / f32(1.281552)
    sigma_f = np.sqrt(np.maximum(sigma_tot ** 2 - f32(
        cfg.anchor_bias_jitter_ln) ** 2, f32(0.0))) / f32(0.707)
    mag = torch.exp(float(np.log(f32(cfg.anchor_bias_median_m)))
                    + float(sigma_f) * fm
                    + cfg.anchor_bias_jitter_ln * prng.normal(k_j))
    if cfg.anchor_gross_p > 0.0:
        gross = prng.uniform(k_g) < cfg.anchor_gross_p
        gmag = torch.exp(prng.uniform(
            k_gm, (), float(np.log(f32(cfg.anchor_gross_lo_m))),
            float(np.log(f32(cfg.anchor_gross_hi_m)))))
        mag = torch.where(gross, gmag, mag)
    th = torch.atan2(fy, fx) + cfg.anchor_bias_dir_jitter * prng.normal(k_dj)
    return mag[..., None] * torch.stack([torch.cos(th), torch.sin(th)], -1)


def _block_dead(li, off, cfg: LandmarkConfig):
    """Cross-session appearance death per along-route landmark block (a
    golden-ratio low-discrepancy sequence over blocks of
    ``dead_block_landmarks`` slots; ``off`` is the per-route phase)."""
    block = li // max(cfg.dead_block_landmarks, 1)
    u = _pymod(block.to(torch.float32) * _f32(0.6180339887) + off, 1.0)
    return u < cfg.session_dead_frac


def match_tick(store: LandmarkStore, obs: Observation, vio_xy, vio_heading,
               base_pos_vio, key, cam: CameraConfig, cfg: LandmarkConfig,
               consistency_extra_m=0.0) -> AnchorResult:
    """One 2 Hz anchor attempt per route.  vio_xy (B, 2) and vio_heading
    (B,) are the query pose (``base_pos_vio`` (B, 3) is accepted for the
    JAX package's signature and not read); key (B, 2);
    ``consistency_extra_m`` widens the anchor-vs-query consistency gate (a
    float or (B,))."""
    B, L = store.count.shape[0], cfg.max_landmarks
    C = cfg.max_candidates
    dev = vio_xy.device
    rows = torch.arange(B, device=dev)
    lm_valid = torch.arange(L, device=dev) < store.count[:, None]

    # candidate gate: distance < 8 m AND heading within 90°
    d = torch.linalg.vector_norm(store.cam_pos[..., :2] - vio_xy[:, None],
                                 dim=-1)
    dy = store.cam_yaw - vio_heading[:, None]
    hdg_err = torch.atan2(torch.sin(dy), torch.cos(dy)).abs()
    cand = lm_valid & (d < cfg.candidate_radius_m) & \
        (hdg_err < _f32(math.radians(cfg.heading_tol_deg)))
    d_masked = torch.where(cand, d, torch.full_like(d, float("inf")))
    top = torch.sort(d_masked, dim=-1, stable=True).indices[:, :C]   # (B, C)
    top_ok = torch.isfinite(torch.gather(d_masked, 1, top))
    any_cand = top_ok.any(1)

    live_valid = obs.valid
    enough_live = live_valid.sum(1) >= cfg.min_matches
    sess_off = _pymod(store.cam_pos[:, 0, 0] * _f32(0.7548777)
                      + store.cam_pos[:, 0, 1] * _f32(0.5698403), 1.0)
    keys = prng.split(key, C)                              # (B, C, 2)

    # all routes x candidates in one K1 launch; candidates share the live
    # frame of their route
    F = cfg.feats_per_landmark
    t_desc = store.desc[rows[:, None], top]                # (B, C, F, W)
    t_valid = store.feat_valid[rows[:, None], top]         # (B, C, F)
    m_idx, matched = cross_check_match(
        t_desc.reshape(B * C, F, -1), t_valid.reshape(B * C, F),
        obs.desc, live_valid, site="matcher")
    m_idx, matched = m_idx.reshape(B, C, F), matched.reshape(B, C, F)
    dead = _block_dead(top, sess_off[:, None], cfg)
    matched = matched & ~dead[..., None]
    enough = matched.sum(-1) >= cfg.min_matches

    p3d_t = store.p3d_cam[rows[:, None], top]              # (B, C, F, 3)
    uv_l = _take_last(obs.uv[:, None].expand(B, C, -1, 2), m_idx)
    p3d_l = _take_last(obs.p3d_cam[:, None].expand(B, C, -1, 3), m_idx)
    R, t, n_inls, meds, pnp_ok = ransac_pose(p3d_t, uv_l, p3d_l, matched,
                                             keys, cam, cfg)

    # compose: teach-cam world pose ∘ (T_live_teach)^-1 -> live cam world
    cyaw = store.cam_yaw[rows[:, None], top]
    c, s = torch.cos(cyaw), torch.sin(cyaw)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    Rz = torch.stack([c, -s, zero, s, c, zero, zero, zero, one],
                     -1).reshape(B, C, 3, 3)
    R_w_t = ordered.mm(Rz, torch.tensor(R_BASE_CAM, device=dev))
    t_t_l = -ordered.mm(R.transpose(-1, -2), t[..., None])[..., 0]
    cam_worlds = store.cam_pos[rows[:, None], top] + \
        ordered.mm(R_w_t, t_t_l[..., None])[..., 0]
    oks = top_ok & enough & pnp_ok

    score = torch.where(oks, n_inls, torch.full_like(n_inls, -1))
    best = score.argmax(1)
    best_ok = oks[rows, best] & enough_live
    cam_world = cam_worlds[rows, best]
    # camera world -> base world (reverse the forward camera offset)
    bx = cam_world[:, 0] - cam.cam_offset_fwd * torch.cos(vio_heading)
    by = cam_world[:, 1] - cam.cam_offset_fwd * torch.sin(vio_heading)
    anchor_xy = torch.stack([bx, by], -1)
    if cfg.anchor_bias_median_m > 0.0:
        lm_xy = store.cam_pos[rows, top[rows, best], :2]
        anchor_xy = anchor_xy + sample_anchor_bias(
            lm_xy, prng.fold_in(key, 7), cfg)

    cons_d = torch.linalg.vector_norm(anchor_xy - vio_xy, dim=-1)
    published = best_ok & (cons_d <= cfg.consistency_m + consistency_extra_m)

    n_inl = n_inls[rows, best]
    nf = n_inl.to(torch.float32)
    std = torch.where(
        n_inl >= cfg.inlier_hi, torch.full_like(nf, cfg.std_good),
        torch.where(n_inl >= cfg.inlier_lo,
                    cfg.std_good + 0.15 * (cfg.inlier_hi - nf) / 10.0,
                    torch.full_like(nf, cfg.std_bad)))

    def code(v):
        return torch.full_like(n_inl, v)

    reason = torch.where(published, code(R_PUBLISHED),
                         torch.where(~enough_live, code(R_NO_FEATURES),
                                     torch.where(~any_cand,
                                                 code(R_NO_CANDIDATES),
                                                 torch.where(
                                                     best_ok,
                                                     code(R_CONSISTENCY_FAIL),
                                                     code(R_NO_PNP_ACCEPT)))))
    return AnchorResult(xy=anchor_xy, std=std, ok=published,
                        n_inliers=n_inl, reproj=meds[rows, best],
                        reason=reason)
