"""Shared CLI plumbing: mode selection, artefact writing
(``nclt_slam_tpu/cli/common.py``).

The modes map to the presets the JAX package's CLI uses: ``rgbd`` is
``config.rgbd_no_imu()`` (no GT-stall watchdog), as in the JAX CLI, not
``baselines.configs.rgbd_no_imu()``, which the calibration front end
(``tools/torch_calibrate.py``) runs.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from nclt_slam_tpu_torch import config as cfg_mod
from nclt_slam_tpu_torch.baselines import stock_nav2
from nclt_slam_tpu_torch.eval.metrics import procrustes_align_2d
from nclt_slam_tpu_torch.io.artifacts import (
    _host,
    save_landmarks_pkl,
    save_teach_map,
    save_traj_gt,
    save_vio_pose_dense,
)

MODES = {
    "ours": cfg_mod.ours,
    "gt": cfg_mod.gt_localization,
    "encoder": cfg_mod.encoder_only,
    "rgbd": cfg_mod.rgbd_no_imu,
    "stock": stock_nav2,
}


def config_for(mode: str, scale: float = 1.0):
    """The mode's preset with the depth-ray grid scaled by ``scale`` (a
    cheaper sensor for CPU runs; 1.0 is the full width)."""
    cfg = MODES[mode]()
    if scale != 1.0:
        cam = cfg.camera
        cfg = cfg.replace(camera=dataclasses.replace(
            cam,
            ray_cols=max(8, int(cam.ray_cols * scale)),
            ray_rows=max(6, int(cam.ray_rows * scale)),
        ))
    return cfg


def _row0(x) -> np.ndarray:
    """Route 0 of a batched trace field (a tensor or a numpy array)."""
    return _host(x)[0]


def write_teach_artifacts(out_dir, teach, route, cfg):
    """Write the reference teach artefact set from the TeachResult of one
    route (a batch of 1)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    gt = _row0(teach.trace.gt_xy)
    yaw = _row0(teach.trace.gt_yaw)
    done = _row0(teach.trace.done)
    live = ~done
    ts = np.arange(len(gt)) * 0.1

    save_teach_map(_row0(teach.teach_grid), out / "teach_map", cfg.map)
    save_landmarks_pkl(teach.store, out / "landmarks.pkl", cfg.camera,
                       cfg.landmarks)
    # vio_pose_dense carries the teach VIO track aligned to GT (what the
    # reference drift monitor writes); with run_vio off it degenerates to
    # GT, like the --use-gt relay
    if cfg.teach.run_vio:
        vio = _row0(teach.trace.vio_xy)
        pose_xy = procrustes_align_2d(vio[live], gt[live])
    else:
        pose_xy = gt[live]
    slam = np.column_stack([pose_xy, np.zeros(live.sum()),
                            np.zeros((live.sum(), 2)),
                            np.sin(yaw[live] / 2), np.cos(yaw[live] / 2)])
    save_vio_pose_dense(out / "vio_pose_dense.csv", ts[live], slam, gt[live])
    save_traj_gt(out / "traj_gt.csv", ts[live], gt[live], yaw[live])
    return out


def write_repeat_artifacts(out_dir, rep, cfg):
    """traj_gt.csv and nav_pose.csv of the RepeatResult of one route."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    gt = _row0(rep.trace.gt_xy)
    yaw = _row0(rep.trace.gt_yaw)
    nav = _row0(rep.trace.nav_xy)
    ts = np.arange(len(gt)) * 0.1
    save_traj_gt(out / "traj_gt.csv", ts, gt, yaw)
    np.savetxt(out / "nav_pose.csv",
               np.column_stack([ts, nav]), delimiter=",",
               header="ts,nav_x,nav_y", comments="")
    return out


def write_metrics(out_dir, metrics: dict):
    p = Path(out_dir) / "metrics.json"
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(metrics, indent=2, default=str))
    return p


def batch1(tree):
    """A NamedTuple of tensors (a packed scene or route) as a batch of 1."""
    return type(tree)(*(x[None] for x in tree))


def add_device_arg(ap):
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; raises "
                         "without one: pass --device cpu for a CPU run)")
