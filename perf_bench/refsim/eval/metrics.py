"""Metric engine — port of the reference's thesis metrics (the campaign
half of ``nclt_slam_tpu/eval/metrics.py`` and its 2-D Procrustes
alignments, copied as numpy, the trajectory errors ATE/RPE of the LiDAR
SLAM path, and the place-recognition precision/recall curve and average
precision).

compute_metrics.py semantics, bit-comparable where the inputs align:
- directional WP coverage: split teach WPs and the GT trace at the
  turnaround; an outbound WP counts only if the outbound GT half passes
  within 3 m, a return WP only against the return half (:94-129)
- endpoint success: min distance to turnaround over the run ("reach") and
  final distance to spawn ("return"), 10 m threshold (:132-149)
- drift mean/p95/max from |nav - gt| sampled at the relay's logging cadence
  (the reference regex-scrapes ``err=N.Nm`` lines at 1/100 ticks; we sample
  the same quantity from the trace) (:152-167)
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# campaign metrics (compute_metrics.py port)
# ---------------------------------------------------------------------------

def subsample_wps(pts: np.ndarray, spacing: float = 4.0) -> np.ndarray:
    """send_goals-style >= spacing subsample (first point kept)."""
    if len(pts) == 0:
        return pts
    keep = [pts[0]]
    for p in pts[1:]:
        if np.hypot(*(p - keep[-1])) >= spacing:
            keep.append(p)
    return np.asarray(keep)


def wp_coverage(gt_pts: np.ndarray, wps: np.ndarray, turnaround_xy,
                r_tol: float = 3.0):
    """Direction-aware waypoint coverage on an out-and-back route.

    Both the driven GT trace and the teach waypoint list are cut at the
    sample nearest the turnaround point; waypoints on the outbound half
    only score against the outbound leg of the trace (and return waypoints
    against the return leg), so driving one leg twice cannot double-count
    the other leg's waypoints.  A waypoint counts as covered when its leg
    of the trace passes within ``r_tol`` meters.  Semantics match the
    reference oracle (compute_metrics.py:94-129).  Returns
    (covered_count, total, per-waypoint min distances)."""
    if len(gt_pts) == 0 or len(wps) == 0:
        return 0, len(wps), []
    n = len(wps)
    tx, ty = turnaround_xy
    cut = int(np.argmin(np.hypot(gt_pts[:, 0] - tx, gt_pts[:, 1] - ty)))
    wp_cut = int(np.argmin(np.hypot(wps[:, 0] - tx, wps[:, 1] - ty)))
    leg_out = gt_pts[: cut + 1]
    leg_back = gt_pts[cut:] if cut < len(gt_pts) else gt_pts[-1:]

    covered = 0
    dists = []
    for i, (wx, wy) in enumerate(wps):
        leg = leg_out if i <= wp_cut else leg_back
        d = float(np.hypot(leg[:, 0] - wx, leg[:, 1] - wy).min())
        dists.append(d)
        if d < r_tol:
            covered += 1
    return covered, n, dists


def endpoint_metrics(gt_pts: np.ndarray, spawn_xy, turnaround_xy,
                     tol: float = 10.0):
    """Route-endpoint success pair: closest approach to the turnaround over
    the whole run (did the robot ever reach the far end?) and the distance
    from the run's last sample back to the spawn (did it make it home?),
    each thresholded at ``tol`` meters (compute_metrics.py:132-149
    semantics).  Returns (reach_dist, home_dist, reached, returned)."""
    if len(gt_pts) == 0:
        return None, None, False, False
    tx, ty = turnaround_xy
    reach_d = float(np.hypot(gt_pts[:, 0] - tx, gt_pts[:, 1] - ty).min())
    sx, sy = spawn_xy
    home_d = float(np.hypot(gt_pts[-1, 0] - sx, gt_pts[-1, 1] - sy))
    return reach_d, home_d, reach_d < tol, home_d < tol


def drift_metrics(nav_xy: np.ndarray, gt_xy: np.ndarray, period: int = 100):
    """mean/p95/max of |nav - gt| sampled every ``period`` ticks (the
    reference's err= log cadence)."""
    if len(nav_xy) == 0:
        return None, None, None, 0
    errs = np.hypot(*(nav_xy[::period] - gt_xy[::period]).T)
    errs = np.sort(errs)
    n = len(errs)
    if n == 0:
        return None, None, None, 0
    p95 = errs[min(n - 1, int(round(0.95 * (n - 1))))]
    return float(errs.mean()), float(p95), float(errs[-1]), n


def route_metrics(gt_xy: np.ndarray, nav_xy: np.ndarray, teach_wps: np.ndarray,
                  spawn_xy, turnaround_xy, wp_tol=3.0, endpoint_tol=10.0,
                  drift_period=100) -> dict:
    """Full scan_run equivalent on in-memory traces."""
    # a NaN'd rollout counts as a hard failure, not NaN-poisoned averages
    finite = np.isfinite(gt_xy).all(-1) & np.isfinite(nav_xy).all(-1)
    gt_xy = gt_xy[finite]
    nav_xy = nav_xy[finite]
    path_m = float(np.hypot(*np.diff(gt_xy, axis=0).T).sum()) if len(gt_xy) > 1 else 0.0
    v, t, _ = wp_coverage(gt_xy, teach_wps, turnaround_xy, wp_tol)
    final_d, return_d, rf, rs = endpoint_metrics(gt_xy, spawn_xy, turnaround_xy,
                                                 endpoint_tol)
    m_mean, m_p95, m_max, m_n = drift_metrics(nav_xy, gt_xy, drift_period)
    return {
        "gt_samples": int(len(gt_xy)),
        "path_m": path_m,
        "cov_visited": v, "cov_total": t,
        "cov_pct": 100.0 * v / t if t else None,
        "final_d": final_d, "return_d": return_d,
        "reached_final": bool(rf), "returned_spawn": bool(rs),
        "drift_mean": m_mean, "drift_p95": m_p95, "drift_max": m_max,
        "drift_n": m_n,
    }


def aggregate_metrics(per_route: dict[str, dict]) -> dict:
    """Campaign aggregate (the reference's bottom table)."""
    rows = list(per_route.values())
    covs = [r["cov_pct"] for r in rows
            if r["cov_pct"] is not None and np.isfinite(r["cov_pct"])]
    drifts = [r["drift_mean"] for r in rows
              if r["drift_mean"] is not None and np.isfinite(r["drift_mean"])]
    return {
        "routes": len(rows),
        "reach": sum(1 for r in rows if r["reached_final"]),
        "return": sum(1 for r in rows if r["returned_spawn"]),
        "full_success": sum(1 for r in rows
                            if r["reached_final"] and r["returned_spawn"]),
        "avg_coverage_pct": float(np.mean(covs)) if covs else None,
        "avg_drift_mean": float(np.mean(drifts)) if drifts else None,
        "avg_final_d": float(np.mean(
            [r["final_d"] for r in rows
             if r["final_d"] is not None and np.isfinite(r["final_d"])])),
    }


# ---------------------------------------------------------------------------
# 2-D Procrustes alignment (vio_drift_monitor port)
# ---------------------------------------------------------------------------

PROCRUSTES_FLIPS = ((1, 1), (-1, 1), (1, -1), (-1, -1))


def procrustes_flips_2d(vio_xy: np.ndarray, gt_xy: np.ndarray):
    """The drift monitor's four axis flips of a 2-D VIO track (in
    ``PROCRUSTES_FLIPS``' order), each rotation+translation aligned to GT:
    returns (aligned tracks, a list of four (T, 2) arrays; their mean
    alignment errors, a list of four scalars), in the input's dtype."""
    xg, yg = gt_xy[:, 0], gt_xy[:, 1]
    cxg, cyg = xg.mean(), yg.mean()
    dxg, dyg = xg - cxg, yg - cyg
    tracks, errs = [], []
    for fx, fy in PROCRUSTES_FLIPS:
        xv, yv = vio_xy[:, 0] * fx, vio_xy[:, 1] * fy
        dxv, dyv = xv - xv.mean(), yv - yv.mean()
        a = (dxv * dxg + dyv * dyg).sum()
        b = (dxv * dyg - dyv * dxg).sum()
        th = np.arctan2(b, a)
        c, s = np.cos(th), np.sin(th)
        rx = c * dxv - s * dyv + cxg
        ry = s * dxv + c * dyv + cyg
        tracks.append(np.stack([rx, ry], -1))
        errs.append(np.hypot(rx - xg, ry - yg).mean())
    return tracks, errs


def procrustes_pick(errs):
    """Index of the flip the alignment keeps: the first of least mean error
    (None when every error is NaN)."""
    best, best_mean = None, np.inf
    for k, err in enumerate(errs):
        if err < best_mean:
            best, best_mean = k, err
    return best


def procrustes_align_2d(vio_xy: np.ndarray, gt_xy: np.ndarray) -> np.ndarray:
    """Align a 2-D VIO track to GT with the drift monitor's handedness-robust
    4-flip rotation+translation Procrustes; returns the aligned track.  This
    is the transform the reference applies when writing vio_pose_dense.csv
    (the repeat waypoint source).  On a straight track the flips about the
    line tie, and rounding decides which one is kept."""
    if len(vio_xy) < 2:
        return np.asarray(gt_xy[: len(vio_xy)])
    tracks, errs = procrustes_flips_2d(vio_xy, gt_xy)
    k = procrustes_pick(errs)
    return None if k is None else tracks[k]


def procrustes_drift_2d(vio_xyz: np.ndarray, gt_xy: np.ndarray):
    """Handedness-robust 2-D Procrustes VIO->GT (vio_drift_monitor port):
    picks the two highest-variance VIO axes, tries all four axis-flips,
    rotation+translation aligns each, returns (max, mean) residual of the
    best."""
    variances = np.var(vio_xyz, axis=0)
    h0, h1 = np.argsort(variances)[::-1][:2]
    xv_base, yv_base = vio_xyz[:, h0], vio_xyz[:, h1]
    xg, yg = gt_xy[:, 0], gt_xy[:, 1]
    cx_g, cy_g = xg.mean(), yg.mean()
    dxg, dyg = xg - cx_g, yg - cy_g

    best = None
    for fx, fy in ((1, 1), (-1, 1), (1, -1), (-1, -1)):
        xv, yv = xv_base * fx, yv_base * fy
        dxv, dyv = xv - xv.mean(), yv - yv.mean()
        a = (dxv * dxg + dyv * dyg).sum()
        b = (dxv * dyg - dyv * dxg).sum()
        th = np.arctan2(b, a)
        c, s = np.cos(th), np.sin(th)
        rx = c * dxv - s * dyv + cx_g
        ry = s * dxv + c * dyv + cy_g
        err = np.hypot(rx - xg, ry - yg)
        if best is None or err.mean() < best.mean():
            best = err
    return float(best.max()), float(best.mean())


# ---------------------------------------------------------------------------
# trajectory errors (the LiDAR SLAM path's ATE ladder)
# ---------------------------------------------------------------------------

def align_umeyama_2d(est: np.ndarray, gt: np.ndarray, with_scale=False):
    """2-D Umeyama alignment est->gt.  Returns (R, t, s)."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    ec, gc = est - mu_e, gt - mu_g
    cov = gc.T @ ec / len(est)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(2)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[1, 1] = -1
    R = U @ S @ Vt
    s = float((D * S.diagonal()).sum() / (ec ** 2).sum() * len(est)) \
        if with_scale else 1.0
    t = mu_g - s * R @ mu_e
    return R, t, s


def ate_rmse(est: np.ndarray, gt: np.ndarray, with_scale=False) -> float:
    """Absolute trajectory error RMSE after 2-D (Sim/SE) alignment — the
    NCLT/RobotCar evaluation metric."""
    R, t, s = align_umeyama_2d(est, gt, with_scale)
    aligned = (s * (R @ est.T)).T + t
    return float(np.sqrt(((aligned - gt) ** 2).sum(-1).mean()))


def rpe_rmse(est: np.ndarray, gt: np.ndarray, delta: int = 10) -> float:
    """Relative pose (translation) error RMSE over ``delta``-step intervals."""
    e = est[delta:] - est[:-delta]
    g = gt[delta:] - gt[:-delta]
    return float(np.sqrt(((np.linalg.norm(e, axis=-1)
                           - np.linalg.norm(g, axis=-1)) ** 2).mean()))


def pr_curve(scores: np.ndarray, is_match: np.ndarray):
    """Precision/recall curve over match scores (higher = more confident),
    the Kaggle place-recognition evaluation protocol
    (datasets/nclt_kaggle/src/evaluation/metrics.py)."""
    order = np.argsort(-scores)
    tp = np.cumsum(is_match[order])
    fp = np.cumsum(~is_match[order])
    precision = tp / np.maximum(tp + fp, 1)
    recall = tp / max(int(is_match.sum()), 1)
    return precision, recall


def average_precision(scores: np.ndarray, is_match: np.ndarray) -> float:
    p, r = pr_curve(scores, is_match)
    return float(np.trapezoid(p, r)) if hasattr(np, "trapezoid") \
        else float(np.trapz(p, r))
