"""GPS coordinate conversions (datasets/nclt_kaggle/src/utils/gps_utils.py;
``nclt_slam_tpu/datasets/utils/gps.py``, a numpy copy): LLA -> ECEF ->
local ENU, WGS-84."""

from __future__ import annotations

import numpy as np

WGS84_A = 6_378_137.0
WGS84_F = 1.0 / 298.257223563
WGS84_E2 = WGS84_F * (2.0 - WGS84_F)


def lla_to_ecef(lat, lon, alt):
    """Geodetic (radians, meters) -> ECEF.  Vectorized."""
    lat, lon, alt = map(np.asarray, (lat, lon, alt))
    sin_lat, cos_lat = np.sin(lat), np.cos(lat)
    N = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sin_lat ** 2)
    x = (N + alt) * cos_lat * np.cos(lon)
    y = (N + alt) * cos_lat * np.sin(lon)
    z = (N * (1.0 - WGS84_E2) + alt) * sin_lat
    return np.stack([x, y, z], -1)


def ecef_to_enu(ecef, lat0, lon0, alt0):
    """ECEF -> local ENU around reference geodetic origin (radians)."""
    ref = lla_to_ecef(lat0, lon0, alt0)
    d = np.asarray(ecef) - ref
    sl, cl = np.sin(lat0), np.cos(lat0)
    so, co = np.sin(lon0), np.cos(lon0)
    R = np.array([
        [-so, co, 0.0],
        [-sl * co, -sl * so, cl],
        [cl * co, cl * so, sl],
    ])
    return d @ R.T


def lla_to_enu(lat, lon, alt, lat0, lon0, alt0):
    """Geodetic (radians) -> ENU around the first-fix origin."""
    return ecef_to_enu(lla_to_ecef(lat, lon, alt), lat0, lon0, alt0)
