"""Pseudo-IMU synthesis from an INS navigation solution + EuRoC import
(``nclt_slam_tpu/io/ins_imu.py``, a numpy copy).

Port of the RobotCar pipeline's INS->IMU math
(datasets/robotcar/scripts/synthesize_imu.py:28-186): the Novatel SPAN INS
publishes position/velocity/attitude but no raw inertial stream, so a
pseudo-IMU is differentiated from it —

    omega_body = T(roll, pitch) @ [droll, dpitch, dyaw]   (ZYX rates -> gyro)
    accel_body = R_ned_to_body @ (dv_ned/dt - g_ned)      (specific force)

with NED gravity g = [0, 0, +9.81].  Vectorized numpy (host-side IO), with
the same smoothed mid-point derivatives as the reference.  Together with
the port's io.euroc this closes the RobotCar/4Seasons ingestion loop:
EuRoC trees can be both written AND read back into our evaluation
protocol.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

GRAVITY = 9.81007  # reference's value (synthesize_imu.py:113)


def _smooth_derivative(signal, dt_mean, window: int = 5):
    """np.gradient + centered uniform filter (smooth_derivative port)."""
    d = np.gradient(signal, dt_mean, edge_order=2)
    if window > 1:
        kernel = np.ones(window) / window
        pad = window // 2
        padded = np.pad(d, pad, mode="edge")
        d = np.convolve(padded, kernel, mode="valid")[: len(d)]
    return d


def ned_to_body_rotation(roll, pitch, yaw):
    """NED-to-body DCM, ZYX convention (RobotCar SDK) — vectorized over
    leading dims."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    R = np.stack([
        np.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1),
        np.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1),
        np.stack([-sp, cp * sr, cp * cr], -1),
    ], -2)
    return R


def euler_rates_to_body_rates(roll, pitch, d_roll, d_pitch, d_yaw):
    """ZYX Euler rates -> body angular velocity (synthesize_imu.py:44-57)."""
    wx = d_roll - np.sin(pitch) * d_yaw
    wy = np.cos(roll) * d_pitch + np.sin(roll) * np.cos(pitch) * d_yaw
    wz = -np.sin(roll) * d_pitch + np.cos(roll) * np.cos(pitch) * d_yaw
    return np.stack([wx, wy, wz], -1)


def synthesize_imu_from_ins(t_s, vel_ned, rpy, gravity: float = GRAVITY,
                            smooth_window: int = 5):
    """INS stream -> pseudo-IMU.

    t_s (N,) seconds; vel_ned (N, 3) NED velocities; rpy (N, 3) roll/pitch/yaw
    (ZYX, NED).  Returns (t_mid (N-1,), gyro_body (N-1, 3),
    accel_body (N-1, 3)) at mid-point timestamps like the reference.
    """
    t_s = np.asarray(t_s, np.float64)
    vel = np.asarray(vel_ned, np.float64)
    rpy = np.asarray(rpy, np.float64)
    dt_mean = float(np.mean(np.diff(t_s)))
    t_mid = 0.5 * (t_s[:-1] + t_s[1:])

    yaw_un = np.unwrap(rpy[:, 2])
    d_roll = _smooth_derivative(rpy[:, 0], dt_mean, smooth_window)
    d_pitch = _smooth_derivative(rpy[:, 1], dt_mean, smooth_window)
    d_yaw = _smooth_derivative(yaw_un, dt_mean, smooth_window)

    roll_m = 0.5 * (rpy[:-1, 0] + rpy[1:, 0])
    pitch_m = 0.5 * (rpy[:-1, 1] + rpy[1:, 1])
    yaw_m = 0.5 * (yaw_un[:-1] + yaw_un[1:])

    gyro = euler_rates_to_body_rates(
        roll_m, pitch_m, d_roll[:-1], d_pitch[:-1], d_yaw[:-1])

    a_ned = np.stack([_smooth_derivative(vel[:, k], dt_mean, smooth_window)
                      for k in range(3)], -1)
    sf_ned = a_ned[:-1].copy()
    sf_ned[:, 2] -= gravity                    # g points +down in NED

    # the constructed DCM maps body->NED (standard ZYX R_nb); its transpose
    # takes the NED specific force into the body frame, same as the
    # reference's R.T application (synthesize_imu.py:166-168)
    R_nb = ned_to_body_rotation(roll_m, pitch_m, yaw_m)   # (N-1, 3, 3)
    accel = np.einsum("nji,nj->ni", R_nb, sf_ned)
    return t_mid, gyro.astype(np.float32), accel.astype(np.float32)


def load_euroc_imu(mav0_dir):
    """Read an EuRoC imu0/data.csv -> (t_s, gyro (M,3), accel (M,3))."""
    p = Path(mav0_dir) / "imu0" / "data.csv"
    raw = np.loadtxt(p, delimiter=",", comments="#")
    return raw[:, 0] * 1e-9, raw[:, 1:4], raw[:, 4:7]


def load_euroc_session(mav0_dir):
    """Full EuRoC mav0 import: GT trajectory + IMU + cam timestamps.

    Returns dict(t_gt, xyz, quat_xyzw, t_imu, gyro, accel, t_cam) with
    missing streams as None — the import direction the reference pipelines
    lacked (they only converted TO EuRoC)."""
    from nclt_slam_tpu_torch.io.euroc import load_euroc_groundtruth

    root = Path(mav0_dir)
    t_gt, xyz, quat = load_euroc_groundtruth(root)
    out = {"t_gt": t_gt, "xyz": xyz, "quat_xyzw": quat,
           "t_imu": None, "gyro": None, "accel": None, "t_cam": None}
    if (root / "imu0" / "data.csv").exists():
        out["t_imu"], out["gyro"], out["accel"] = load_euroc_imu(root)
    cam = root / "cam0" / "data.csv"
    if cam.exists():
        ts = np.loadtxt(cam, delimiter=",", comments="#", usecols=0,
                        dtype=np.int64, converters=None)
        out["t_cam"] = np.atleast_1d(ts) * 1e-9
    return out
