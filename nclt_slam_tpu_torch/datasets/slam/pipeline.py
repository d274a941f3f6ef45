"""LiDAR odometry + SLAM pipeline driver
(``nclt_slam_tpu/datasets/slam/pipeline.py``).

Chain scan-to-local-map ICP over a session with wheel-odometry prediction,
maintain the sliding local map, detect loop closures (ScanContext + GPS
gate), register each candidate (FPFH-RANSAC + ICP) and optimize the 2-D
pose graph.  ``run_slam`` runs on the CUDA card unless the caller names
another device (``device="cpu"``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from nclt_slam_tpu_torch.core import prng
from nclt_slam_tpu_torch.datasets.slam.icp import (
    icp_point_to_point,
    init_local_map,
    local_map_flat,
    local_map_insert,
)
from nclt_slam_tpu_torch.datasets.slam.loop_closure import (
    PoseGraph2D,
    detect_loops,
    detect_loops_scalable,
    optimize_pose_graph,
    optimize_pose_graph_fast,
    scan_context,
)
from nclt_slam_tpu_torch.datasets.slam.registration import register_loop

STAGES = ("odometry", "descriptors", "detection", "registration", "pgo")


def slam_device(device=None) -> torch.device:
    """The device a session runs on: the CUDA card unless the caller names
    another.  Raises when no card is present and none was named."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "session on the CPU")
    return torch.device("cuda")


def run_icp_odometry(scans, scan_valid, odom_pred=None, local_map_scans=20,
                     icp_iters=15, max_corr=1.0, device=None):
    """Scan-to-local-map ICP odometry, one scan at a time through the host
    (the pose chain in float64 numpy, as the JAX package keeps it).

    scans: (T, N, 3) downsampled scans in the sensor frame (numpy).
    odom_pred: optional (T, 4, 4) wheel-odometry relative predictions.
    Returns (poses (T, 4, 4) world<-sensor, rmses (T,)) as numpy."""
    dev = slam_device(device)
    scans = np.asarray(scans)
    scan_valid = np.asarray(scan_valid)
    T_n, N = scans.shape[0], scans.shape[1]

    def t32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def tb(a):
        return torch.as_tensor(a, device=dev)

    lm = init_local_map(local_map_scans, N, dev)
    pose = np.eye(4)
    poses = [pose.copy()]
    rmses = [0.0]

    lm = local_map_insert(lm, t32(scans[0]), tb(scan_valid[0]))
    for t in range(1, T_n):
        pred = np.eye(4) if odom_pred is None else np.asarray(odom_pred[t])
        guess = pose @ pred
        dst, dv = local_map_flat(lm)
        res = icp_point_to_point(t32(scans[t]), tb(scan_valid[t]), dst, dv,
                                 R0=t32(guess[:3, :3]), t0=t32(guess[:3, 3]),
                                 iters=icp_iters, max_corr=max_corr)
        pose = np.eye(4)
        pose[:3, :3] = res.R.cpu().numpy()
        pose[:3, 3] = res.t.cpu().numpy()
        poses.append(pose.copy())
        rmses.append(float(res.rmse))
        world_scan = scans[t] @ pose[:3, :3].T + pose[:3, 3]
        lm = local_map_insert(lm, t32(world_scan), tb(scan_valid[t]))
    return np.stack(poses), np.asarray(rmses)


def run_icp_odometry_scan(scans, scan_valid, odom_rel=None,
                          local_map_scans=20, icp_iters=15, max_corr=1.0,
                          device=None):
    """Device-resident ICP odometry: scans, the sliding local map and the
    pose chain stay on the device, and the loop over scans issues device
    work with no host synchronization until the end.

    odom_rel: optional (T, 4, 4) relative wheel-odometry predictions.
    Returns (poses (T, 4, 4), rmses (T,)) as numpy."""
    dev = slam_device(device)
    scans = torch.as_tensor(np.asarray(scans, np.float32), device=dev)
    scan_valid = torch.as_tensor(np.asarray(scan_valid), device=dev)
    T_n, N = scans.shape[0], scans.shape[1]
    if odom_rel is None:
        odom_rel = torch.eye(4, device=dev).expand(T_n, 4, 4)
    else:
        odom_rel = torch.as_tensor(np.asarray(odom_rel, np.float32),
                                   device=dev)

    lm = init_local_map(local_map_scans, N, dev)
    lm = local_map_insert(lm, scans[0], scan_valid[0])
    R = torch.eye(3, device=dev)
    t = torch.zeros(3, device=dev)
    Rs, ts, rmses = [], [], []
    for k in range(1, T_n):
        rel = odom_rel[k]
        Rg = R @ rel[:3, :3]
        tg = R @ rel[:3, 3] + t
        dst, dv = local_map_flat(lm)
        res = icp_point_to_point(scans[k], scan_valid[k], dst, dv, R0=Rg,
                                 t0=tg, iters=icp_iters, max_corr=max_corr)
        world = scans[k] @ res.R.T + res.t
        lm = local_map_insert(lm, world, scan_valid[k])
        R, t = res.R, res.t
        Rs.append(R)
        ts.append(t)
        rmses.append(res.rmse)

    poses = torch.eye(4, device=dev).repeat(T_n, 1, 1)
    if T_n > 1:
        poses[1:, :3, :3] = torch.stack(Rs)
        poses[1:, :3, 3] = torch.stack(ts)
    rmses = torch.cat([torch.zeros(1, device=dev),
                       torch.stack(rmses) if rmses else
                       torch.zeros(0, device=dev)])
    return poses.cpu().numpy(), rmses.cpu().numpy()


def odometry_edges(poses2d):
    """The chain's relative measurements (K-1, 3) float32 from 2-D poses
    (K, 3), in numpy as the JAX package computes them."""
    yaw = poses2d[:, 2]
    odo = []
    for k in range(len(poses2d) - 1):
        c, s = np.cos(yaw[k]), np.sin(yaw[k])
        dx = poses2d[k + 1, :2] - poses2d[k, :2]
        odo.append((c * dx[0] + s * dx[1], -s * dx[0] + c * dx[1],
                    yaw[k + 1] - yaw[k]))
    return np.asarray(odo, np.float32).reshape(-1, 3)


def pose_graph(poses2d, loop_i, loop_j, loop_meas, found, device):
    """The 2-D pose graph of an open chain (numpy (K, 3)) and its loops, as
    tensors on ``device``."""
    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a, dtype), device=device)

    return PoseGraph2D(
        poses=t(poses2d, np.float32), odo_meas=t(odometry_edges(poses2d)),
        loop_i=t(loop_i, np.int32), loop_j=t(loop_j, np.int32),
        loop_meas=t(loop_meas, np.float32), loop_valid=t(found, bool))


class _Stages:
    """Wall seconds of each stage into ``out`` (when given), the device
    synchronized at each boundary so that a stage's time is its own."""

    def __init__(self, out, dev):
        self.out, self.dev = out, dev
        self._t = time.perf_counter()

    def done(self, name):
        if self.out is None:
            return
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        now = time.perf_counter()
        self.out[name] = now - self._t
        self._t = now


def run_slam(scans, scan_valid, odom_pred=None, gps_xy=None,
             loop_min_gap=20, sc_thresh=0.3, register_loops=True,
             seed=0, device_resident=None, max_loops=32,
             sc_max_range=80.0, device=None, stage_s=None, **icp_kw):
    """Full LiDAR SLAM: ICP odometry + loop closure + pose-graph optimize.

    ``register_loops``: estimate each loop edge's relative transform with
    FPFH-RANSAC global registration + ICP refine; candidates whose
    registration fails its gates are dropped.  With False, loop edges
    assume an exact revisit (identity).  The RANSAC keys are JAX's:
    ``PRNGKey(seed)``, split once per detected loop.

    ``device_resident``: run the odometry chain with no per-scan host round
    trip (auto: sessions >= 300 scans, which also take the two-stage loop
    search; from 400 scans the pose graph goes through the junction-reduced
    fused PGO, on the card one launch of the K4 kernel).

    ``stage_s``: a dict to receive the wall seconds of each stage
    (``STAGES``).  Returns dict(poses_open, poses_optimized, loops, rmses)
    as numpy."""
    dev = slam_device(device)
    stages = _Stages(stage_s, dev)
    scans = np.asarray(scans)
    scan_valid = np.asarray(scan_valid)
    T_n = scans.shape[0]
    if device_resident is None:
        device_resident = T_n >= 300
    odometry = run_icp_odometry_scan if device_resident else run_icp_odometry
    poses, rmses = odometry(scans, scan_valid, odom_pred, device=dev,
                            **icp_kw)
    stages.done("odometry")

    scans_t = torch.as_tensor(np.asarray(scans, np.float32), device=dev)
    valid_t = torch.as_tensor(scan_valid, device=dev)
    descs = scan_context(scans_t, valid_t, max_range=sc_max_range)
    stages.done("descriptors")

    positions = torch.as_tensor(np.asarray(
        gps_xy if gps_xy is not None else poses[:, :2, 3], np.float32),
        device=dev)
    all_valid = torch.ones(T_n, dtype=torch.bool, device=dev)
    detect = detect_loops_scalable if T_n >= 300 else detect_loops
    li, lj, found = detect(descs, positions, all_valid,
                           min_gap=loop_min_gap, sc_thresh=sc_thresh,
                           max_loops=max_loops)
    li_np, lj_np = li.cpu().numpy(), lj.cpu().numpy()
    found_np = found.cpu().numpy().copy()
    stages.done("detection")

    yaw = np.arctan2(poses[:, 1, 0], poses[:, 0, 0])
    poses2d = np.column_stack([poses[:, 0, 3], poses[:, 1, 3], yaw])

    L = int(found_np.shape[0])
    loop_meas = np.zeros((L, 3), np.float32)
    if register_loops and found_np.any():
        key = prng.PRNGKey(seed, dev)
        for e in np.flatnonzero(found_np):
            i, j = int(li_np[e]), int(lj_np[e])
            key, k = prng.split(key).unbind(0)
            # T_i<-j: align scan j (src) into scan i's sensor frame (dst)
            r = register_loop(scans_t[j], valid_t[j], scans_t[i],
                              valid_t[i], k)
            if not bool(r.ok):
                found_np[e] = False   # registration gate failed -> drop loop
                continue
            R, t = r.R.cpu().numpy(), r.t.cpu().numpy()
            loop_meas[e] = (t[0], t[1], np.arctan2(R[1, 0], R[0, 0]))
    stages.done("registration")

    graph = pose_graph(poses2d, li_np, lj_np, loop_meas, found_np, dev)
    if T_n >= 400:
        # km-scale: junction-reduced PGO (the dense path's normal equations
        # are (3K)^2 at every Gauss-Newton step)
        optimized = optimize_pose_graph_fast(graph, iters=15)
    else:
        optimized = optimize_pose_graph(graph, iters=15)
    optimized = optimized.cpu().numpy()
    stages.done("pgo")
    return {
        "poses_open": poses2d,
        "poses_optimized": optimized,
        "loops": (li_np, lj_np, found_np),
        "rmses": rmses,
    }
