"""Sensor extrinsics manager (datasets/nclt/src/calibration/calibration.py;
``nclt_slam_tpu/datasets/calibration.py``, a numpy copy).

Holds body<-sensor SE(3) transforms (x y z roll pitch yaw parameterization,
NCLT convention) and composes/applies them.  Values default to the NCLT
platform's published calibration.
"""

from __future__ import annotations

import numpy as np

# NCLT platform extrinsics: (x, y, z, roll, pitch, yaw) body<-sensor
DEFAULT_EXTRINSICS = {
    "velodyne": (0.002, -0.004, -0.957, 0.807, 0.166, -90.703),  # deg angles
    "ms25": (-0.11, -0.18, -0.71, 0.0, 0.0, 0.0),
    "lb3": (0.035, 0.002, -1.23, -179.93, -0.23, 0.50),
}


def euler_to_rot(roll, pitch, yaw):
    """ZYX euler (NCLT convention) -> rotation matrix."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


def xyzrpy_to_matrix(x, y, z, roll, pitch, yaw, degrees=False):
    if degrees:
        roll, pitch, yaw = np.deg2rad([roll, pitch, yaw])
    T = np.eye(4)
    T[:3, :3] = euler_to_rot(roll, pitch, yaw)
    T[:3, 3] = (x, y, z)
    return T


class Calibration:
    """body<-sensor transform registry."""

    def __init__(self, extrinsics: dict | None = None, degrees=True):
        self._T = {}
        for name, xyzrpy in (extrinsics or DEFAULT_EXTRINSICS).items():
            self._T[name] = xyzrpy_to_matrix(*xyzrpy, degrees=degrees)

    def body_from(self, sensor: str) -> np.ndarray:
        return self._T[sensor]

    def sensor_from_body(self, sensor: str) -> np.ndarray:
        return np.linalg.inv(self._T[sensor])

    def transform_points(self, sensor: str, pts: np.ndarray) -> np.ndarray:
        """Sensor-frame points (N, 3) -> body frame."""
        T = self._T[sensor]
        return pts @ T[:3, :3].T + T[:3, 3]

    def between(self, a: str, b: str) -> np.ndarray:
        """T such that p_a = T @ p_b (a<-b)."""
        return np.linalg.inv(self._T[a]) @ self._T[b]
