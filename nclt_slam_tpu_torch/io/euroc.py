"""EuRoC-format dataset export (the RobotCar/4Seasons conversion capability;
``nclt_slam_tpu/io/euroc.py``, a numpy copy writing the same bytes).

The reference's dataset pipelines convert stereo/RGB-D sessions to the
EuRoC MAV directory layout so ORB-SLAM3 and hloc can consume them
(datasets/robotcar/scripts/convert_to_euroc.py etc.).  We export our own
simulated sessions (or any (t, pose, imu) stream) the same way:

    mav0/
      cam0/data.csv          # t [ns], filename
      imu0/data.csv          # t [ns], wx, wy, wz, ax, ay, az
      state_groundtruth_estimate0/data.csv
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def export_euroc(out_dir, t_s, gt_xyz, gt_quat_xyzw, imu_t_s=None,
                 imu_gyro=None, imu_accel=None):
    """Write an EuRoC mav0 tree from trajectory + IMU streams.

    t_s: (N,) seconds; gt_xyz (N, 3); gt_quat_xyzw (N, 4).
    imu_*: optional (M,) / (M, 3) streams.
    """
    root = Path(out_dir) / "mav0"
    ns = (np.asarray(t_s) * 1e9).astype(np.int64)

    cam = root / "cam0"
    (cam / "data").mkdir(parents=True, exist_ok=True)
    with open(cam / "data.csv", "w") as f:
        f.write("#timestamp [ns],filename\n")
        for t in ns:
            f.write(f"{t},{t}.png\n")

    gt_dir = root / "state_groundtruth_estimate0"
    gt_dir.mkdir(parents=True, exist_ok=True)
    q = np.asarray(gt_quat_xyzw)
    with open(gt_dir / "data.csv", "w") as f:
        f.write("#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], "
                "q_RS_w [], q_RS_x [], q_RS_y [], q_RS_z []\n")
        for t, p, qi in zip(ns, np.asarray(gt_xyz), q):
            # EuRoC stores quaternions w-first
            f.write(f"{t},{p[0]:.6f},{p[1]:.6f},{p[2]:.6f},"
                    f"{qi[3]:.6f},{qi[0]:.6f},{qi[1]:.6f},{qi[2]:.6f}\n")

    if imu_t_s is not None:
        imu_dir = root / "imu0"
        imu_dir.mkdir(parents=True, exist_ok=True)
        imu_ns = (np.asarray(imu_t_s) * 1e9).astype(np.int64)
        with open(imu_dir / "data.csv", "w") as f:
            f.write("#timestamp [ns],w_RS_S_x [rad s^-1],w_RS_S_y,w_RS_S_z,"
                    "a_RS_S_x [m s^-2],a_RS_S_y,a_RS_S_z\n")
            for t, w, a in zip(imu_ns, np.asarray(imu_gyro),
                               np.asarray(imu_accel)):
                f.write(f"{t},{w[0]:.6f},{w[1]:.6f},{w[2]:.6f},"
                        f"{a[0]:.6f},{a[1]:.6f},{a[2]:.6f}\n")
    return root


def load_euroc_groundtruth(mav0_dir):
    """Read back an EuRoC GT trajectory -> (t_s, xyz, quat_xyzw)."""
    p = Path(mav0_dir) / "state_groundtruth_estimate0" / "data.csv"
    raw = np.loadtxt(p, delimiter=",", comments="#")
    t_s = raw[:, 0] * 1e-9
    xyz = raw[:, 1:4]
    q_wxyz = raw[:, 4:8]
    quat_xyzw = np.column_stack([q_wxyz[:, 1:4], q_wxyz[:, 0]])
    return t_s, xyz, quat_xyzw
