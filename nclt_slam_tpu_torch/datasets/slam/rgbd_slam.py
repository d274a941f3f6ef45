"""RGB-D SLAM baseline — the Gazebo stack's RTAB-Map capability row
(``nclt_slam_tpu/datasets/slam/rgbd_slam.py``).

Feature-based RGB-D frame-to-frame odometry, a keyframe chain,
appearance-based loop closure (a bag-of-binary-words signature, RTAB-Map's
memory-retrieval analog) with 3-D/3-D geometric verification, and the
shared dense 2-D pose-graph backend, on frames rendered by the port's own
sensor model.

Frame pairs are independent, so the port matches all T - 1 odometry pairs
in one batched call of the Hamming cross-check (kernel K1 on the card,
call site ``rgbd_slam``) and the verified loop candidates in a second; the
chain is then composed on the host in float32 numpy, in the JAX package's
order.  Everything runs on the device of the observations handed in.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from nclt_slam_tpu_torch.datasets.slam.loop_closure import (
    PoseGraph2D,
    optimize_pose_graph,
)
from nclt_slam_tpu_torch.landmarks.matcher import _kabsch
from nclt_slam_tpu_torch.sensors.depth import cam_to_base
from nclt_slam_tpu_torch.sensors.features import (
    Observation,
    _take,
    cross_check_match,
)


class RgbdSlamResult(NamedTuple):
    poses_open: np.ndarray      # (T, 3) x, y, yaw — odometry chain
    poses_opt: np.ndarray       # (T, 3) after loop-closed PGO
    loops: tuple                # (i_idx, j_idx, accepted)
    n_matches: np.ndarray       # (T,) frame-to-frame inlier counts


def _body_points(obs: Observation, cam):
    """Observed 3-D points in the body (FLU) frame, (P, K, 3)."""
    t_bc = torch.tensor([cam.cam_offset_fwd, 0.0, cam.cam_offset_up],
                        dtype=torch.float32, device=obs.p3d_cam.device)
    return cam_to_base(obs.p3d_cam) + t_bc


def _residual(P, Q, R, t):
    return torch.linalg.vector_norm(
        torch.matmul(P, R.transpose(-1, -2)) + t[..., None, :] - Q, dim=-1)


def frame_rel_pose(obs_a: Observation, obs_b: Observation, cam):
    """Relative SE(2) pose of frame b in frame a, for P frame pairs at once
    (fields (P, K, ...)): mutual descriptor matches + weighted 3-D Kabsch
    with one inlier re-weighting round (RTAB-Map's F2F visual odometry
    shape).  Returns (dx, dy, dyaw, n_inliers, ok), each (P,)."""
    m_idx, matched, _ = cross_check_match(obs_b.desc, obs_b.valid,
                                          obs_a.desc, obs_a.valid,
                                          return_dist=True,
                                          site="rgbd_slam")
    pa = _take(_body_points(obs_a, cam), m_idx)
    pb = _body_points(obs_b, cam)
    w0 = matched.to(torch.float32)
    R1, t1 = _kabsch(pb, pa, w0)
    w1 = w0 * (_residual(pb, pa, R1, t1) < 0.5)
    R2, t2 = _kabsch(pb, pa, w1)
    inl = (w0 > 0) & (_residual(pb, pa, R2, t2) < 0.3)
    n_inl = inl.sum(-1).to(torch.int32)
    ok = (n_inl >= 8) & torch.isfinite(t2).all(-1)
    dyaw = torch.atan2(R2[:, 1, 0], R2[:, 0, 0])
    zero = torch.zeros_like(dyaw)
    return (torch.where(ok, t2[:, 0], zero), torch.where(ok, t2[:, 1], zero),
            torch.where(ok, dyaw, zero), n_inl, ok)


def frame_signature(obs: Observation) -> torch.Tensor:
    """Bag-of-binary-words appearance signature of each frame: the mean bit
    occupancy of its valid descriptors, (P, 32 W) — rotation and ordering
    invariant, the retrieval key RTAB-Map builds from its vocabulary."""
    P, K, W = obs.desc.shape
    shifts = torch.arange(32, device=obs.desc.device)
    bits = ((obs.desc[..., None] >> shifts) & 1).to(torch.float32) \
        .reshape(P, K, W * 32)
    w = obs.valid.to(torch.float32)[..., None]
    return (bits * w).sum(1) / w.sum(1).clamp_min(1.0)


def _frames(obs: Observation, idx) -> Observation:
    idx = torch.as_tensor(idx, dtype=torch.int64, device=obs.desc.device)
    return Observation(*(x[idx] for x in obs))


def run_rgbd_slam(obs_seq: Observation, cam, loop_min_gap: int = 40,
                  sig_thresh: float = 0.05, max_loops: int = 16,
                  loop_min_inliers: int = 12) -> RgbdSlamResult:
    """Full RGB-D SLAM over a frame sequence: an Observation stacked over T
    frames (fields (T, K, ...)).

    Odometry: the frame-to-frame Kabsch chain.  Loop closure: appearance
    signature shortlist (L1 distance below ``sig_thresh``), geometric
    verification by the same 3-D/3-D estimator at ``loop_min_inliers``,
    then the dense damped-GN 2-D PGO (``loop_closure.optimize_pose_graph``).
    """
    T = obs_seq.desc.shape[0]
    dev = obs_seq.desc.device

    # odometry: all T - 1 frame pairs in one batch
    poses = np.zeros((T, 3), np.float32)
    odo = np.zeros((max(T - 1, 1), 3), np.float32)
    n_matches = np.zeros(T, np.int32)
    if T > 1:
        dx, dy, dyaw, n, _ = frame_rel_pose(_frames(obs_seq, range(T - 1)),
                                            _frames(obs_seq, range(1, T)),
                                            cam)
        rel = torch.stack([dx, dy, dyaw], -1).cpu().numpy()
        odo[:] = rel
        n_matches[1:] = n.cpu().numpy()
    for k in range(1, T):
        dx, dy, dyaw = (float(v) for v in rel[k - 1])
        c, s = np.cos(poses[k - 1, 2]), np.sin(poses[k - 1, 2])
        poses[k] = (poses[k - 1, 0] + c * dx - s * dy,
                    poses[k - 1, 1] + s * dx + c * dy,
                    poses[k - 1, 2] + dyaw)
    sigs = frame_signature(obs_seq).cpu().numpy()

    # appearance retrieval: best-signature candidate pairs beyond min_gap
    d = np.abs(sigs[:, None, :] - sigs[None, :, :]).mean(-1)
    gap = np.abs(np.arange(T)[:, None] - np.arange(T)[None, :])
    d[gap <= loop_min_gap] = np.inf
    d[np.tril_indices(T)] = np.inf
    flat = np.argsort(d.reshape(-1))[:max_loops]
    li, lj = (flat // T).astype(np.int32), (flat % T).astype(np.int32)
    cand_ok = d.reshape(-1)[flat] < sig_thresh

    # geometric verification of the shortlisted candidates, in one batch
    L = max_loops
    loop_meas = np.zeros((L, 3), np.float32)
    loop_valid = np.zeros(L, bool)
    cand = np.flatnonzero(cand_ok)
    if len(cand):
        dx, dy, dyaw, n, ok = frame_rel_pose(_frames(obs_seq, li[cand]),
                                             _frames(obs_seq, lj[cand]), cam)
        meas = torch.stack([dx, dy, dyaw], -1).cpu().numpy()
        accept = ok.cpu().numpy() & (n.cpu().numpy() >= loop_min_inliers)
        loop_meas[cand[accept]] = meas[accept]
        loop_valid[cand[accept]] = True

    graph = PoseGraph2D(
        poses=torch.from_numpy(poses).to(dev),
        odo_meas=torch.from_numpy(odo).to(dev),
        loop_i=torch.from_numpy(li).to(dev),
        loop_j=torch.from_numpy(lj).to(dev),
        loop_meas=torch.from_numpy(loop_meas).to(dev),
        loop_valid=torch.from_numpy(loop_valid).to(dev))
    opt = optimize_pose_graph(graph, iters=15).cpu().numpy()
    return RgbdSlamResult(poses_open=poses, poses_opt=opt,
                          loops=(li, lj, loop_valid), n_matches=n_matches)
