"""NCLT-format sensor loaders + synchronizer + mock-session generator
(``nclt_slam_tpu/datasets/loaders.py``, a numpy copy: the mock session's
files are byte-equal to the JAX package's).

Capability match for datasets/nclt/src/data_loaders/sensor_loader.py and
datasets/nclt_kaggle/src/data/sensor_loader.py: headerless CSV sensor
streams (ms25 IMU, gps_rtk, odometry, kvh heading, groundtruth), nearest-
timestamp synchronization, and a session manager.  The test-fixture
pattern follows the reference's generate_mock_sensors.py: a deterministic
synthetic NE-heading trajectory (seed 42) written as NCLT-format CSVs.

NCLT timestamps are microseconds (int64).
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np

US_TO_S = 1e-6


class SensorStream(NamedTuple):
    t_us: np.ndarray     # (N,) int64 timestamps
    data: np.ndarray     # (N, D)


def _load_csv(path, n_cols):
    raw = np.loadtxt(path, delimiter=",", ndmin=2)
    assert raw.shape[1] >= n_cols, f"{path}: {raw.shape[1]} < {n_cols} cols"
    return SensorStream(t_us=raw[:, 0].astype(np.int64),
                        data=raw[:, 1:n_cols].astype(np.float64))


def load_ms25(path) -> SensorStream:
    """IMU: t, mag(3), accel(3), gyro(3)."""
    return _load_csv(path, 10)


def load_gps_rtk(path) -> SensorStream:
    """GPS: t, mode, num_sats, lat, lon, alt, track, speed."""
    return _load_csv(path, 8)


def load_odometry(path) -> SensorStream:
    """Wheel odometry: t, x, y, theta."""
    return _load_csv(path, 4)


def load_kvh(path) -> SensorStream:
    """Fiber-optic gyro heading: t, heading."""
    return _load_csv(path, 2)


def load_groundtruth(path) -> SensorStream:
    """Groundtruth pose: t, x, y, z, roll, pitch, yaw."""
    return _load_csv(path, 7)


def nearest_sync(ref_t_us: np.ndarray, stream: SensorStream,
                 max_dt_us: int | None = None):
    """Nearest-timestamp association of ``stream`` onto ``ref_t_us``.

    Returns (data (N, D), dt_us (N,), valid (N,))."""
    idx = np.searchsorted(stream.t_us, ref_t_us)
    idx = np.clip(idx, 1, len(stream.t_us) - 1)
    before = stream.t_us[idx - 1]
    after = stream.t_us[idx]
    pick = np.where(ref_t_us - before <= after - ref_t_us, idx - 1, idx)
    dt = np.abs(stream.t_us[pick] - ref_t_us)
    valid = np.ones(len(ref_t_us), bool) if max_dt_us is None else dt <= max_dt_us
    return stream.data[pick], dt, valid


def interpolate_sync(ref_t_us: np.ndarray, stream: SensorStream):
    """Linear interpolation of each data column onto ``ref_t_us``."""
    out = np.stack([
        np.interp(ref_t_us.astype(np.float64),
                  stream.t_us.astype(np.float64), stream.data[:, c])
        for c in range(stream.data.shape[1])], -1)
    return out


class Session:
    """A loaded NCLT-style session directory."""

    SENSORS = {
        "ms25": ("ms25.csv", load_ms25),
        "gps_rtk": ("gps_rtk.csv", load_gps_rtk),
        "odometry": ("odometry_mu_100hz.csv", load_odometry),
        "kvh": ("kvh.csv", load_kvh),
        "groundtruth": ("groundtruth.csv", load_groundtruth),
    }

    def __init__(self, root):
        self.root = Path(root)
        self.streams: dict[str, SensorStream] = {}
        for name, (fname, loader) in self.SENSORS.items():
            p = self.root / fname
            if p.is_file():
                self.streams[name] = loader(p)

    def __getitem__(self, name) -> SensorStream:
        return self.streams[name]

    def __contains__(self, name):
        return name in self.streams

    @property
    def t0_us(self):
        return min(s.t_us[0] for s in self.streams.values())

    def synced(self, ref="groundtruth", max_dt_us=100_000):
        """All streams nearest-synced onto the reference stream's clock."""
        ref_t = self[ref].t_us
        out = {ref: self[ref].data}
        for name, stream in self.streams.items():
            if name == ref:
                continue
            data, _, valid = nearest_sync(ref_t, stream, max_dt_us)
            out[name] = np.where(valid[:, None], data, np.nan)
        return ref_t, out


def generate_mock_session(out_dir, duration_s: float = 10.0, seed: int = 42):
    """Deterministic mock session (the reference's generate_mock_sensors
    pattern): constant NE heading at 1 m/s, 100 Hz GT / 50 Hz IMU / 10 Hz
    GPS / 100 Hz odometry / 10 Hz KVH, fixed seed."""
    rng = np.random.RandomState(seed)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    t0 = 1_326_030_000_000_000  # µs epoch like real NCLT sessions

    heading = np.pi / 4  # NE
    speed = 1.0

    def times(hz):
        n = int(duration_s * hz)
        return t0 + (np.arange(n) * 1e6 / hz).astype(np.int64)

    # groundtruth: t, x, y, z, r, p, yaw  (NCLT x=north, y=east)
    t_gt = times(100.0)
    s = (t_gt - t0) * US_TO_S * speed
    gt = np.column_stack([
        t_gt, s * np.cos(heading), s * np.sin(heading), np.zeros_like(s),
        np.zeros_like(s), np.zeros_like(s), np.full_like(s, heading)])
    np.savetxt(out / "groundtruth.csv", gt, delimiter=",", fmt="%.6f")

    # ms25: t, mag(3), accel(3), gyro(3)
    t_imu = times(50.0)
    n = len(t_imu)
    imu = np.column_stack([
        t_imu,
        rng.normal(0.2, 0.01, (n, 3)),
        np.column_stack([rng.normal(0, 0.05, (n, 2)),
                         rng.normal(9.81, 0.05, n)]),
        rng.normal(0, 0.002, (n, 3))])
    np.savetxt(out / "ms25.csv", imu, delimiter=",", fmt="%.6f")

    # gps_rtk: t, mode, sats, lat, lon, alt, track, speed  (around Ann Arbor)
    t_gps = times(10.0)
    sg = (t_gps - t0) * US_TO_S * speed
    lat0, lon0 = np.deg2rad(42.293227), np.deg2rad(-83.709657)
    R_E = 6_378_137.0
    lat = lat0 + (sg * np.cos(heading)) / R_E
    lon = lon0 + (sg * np.sin(heading)) / (R_E * np.cos(lat0))
    gps = np.column_stack([
        t_gps, np.full_like(sg, 3), np.full_like(sg, 9),
        lat, lon, np.full_like(sg, 270.0),
        np.full_like(sg, heading), np.full_like(sg, speed)])
    np.savetxt(out / "gps_rtk.csv", gps, delimiter=",", fmt="%.9f")

    # odometry: t, x, y, theta  (with slight drift)
    t_odo = times(100.0)
    so = (t_odo - t0) * US_TO_S * speed * 1.005
    odo = np.column_stack([
        t_odo, so * np.cos(heading), so * np.sin(heading),
        np.full_like(so, heading)])
    np.savetxt(out / "odometry_mu_100hz.csv", odo, delimiter=",", fmt="%.6f")

    # kvh: t, heading
    t_kvh = times(10.0)
    kvh = np.column_stack([
        t_kvh, np.full(len(t_kvh), heading) + rng.normal(0, 0.001, len(t_kvh))])
    np.savetxt(out / "kvh.csv", kvh, delimiter=",", fmt="%.6f")
    return out


# ---------------------------------------------------------------------------
# binary LiDAR loaders (velodyne_sync / hokuyo formats)
# ---------------------------------------------------------------------------

def load_velodyne_bin(path) -> np.ndarray:
    """NCLT velodyne_sync .bin scan -> (N, 4) [x, y, z, intensity].

    NCLT packs each point as 3 little-endian uint16 (x, y, z scaled by
    0.005 m with a -100 m offset) + intensity byte + laser-id byte
    (datasets/nclt/src/data_loaders/velodyne_loader.py semantics)."""
    raw = np.fromfile(path, dtype=np.uint8)
    n = len(raw) // 8
    rec = raw[: n * 8].reshape(n, 8)
    xyz_u16 = rec[:, :6].copy().view("<u2").reshape(n, 3)
    xyz = xyz_u16.astype(np.float32) * 0.005 - 100.0
    intensity = rec[:, 6].astype(np.float32)
    return np.column_stack([xyz, intensity])


def save_velodyne_bin(path, xyz, intensity=None):
    """Inverse of load_velodyne_bin (mock/scan export)."""
    n = len(xyz)
    u16 = np.clip((np.asarray(xyz) + 100.0) / 0.005, 0, 65535).astype("<u2")
    rec = np.zeros((n, 8), np.uint8)
    rec[:, :6] = u16.view(np.uint8).reshape(n, 6)
    rec[:, 6] = (intensity if intensity is not None
                 else np.zeros(n)).astype(np.uint8)
    rec[:, 7] = 0
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    rec.tofile(path)
    return path


def load_hokuyo_packets(path, n_rays: int = 1081,
                        angle_span: float = np.deg2rad(270.0)):
    """Hokuyo UTM-30LX packet stream -> (timestamps (K,), ranges (K, R)).

    Stream of [int64 t_us | R float32 ranges] records (planar scans);
    returns ranges in meters with the standard 270° span."""
    rec_bytes = 8 + 4 * n_rays
    raw = np.fromfile(path, dtype=np.uint8)
    k = len(raw) // rec_bytes
    rec = raw[: k * rec_bytes].reshape(k, rec_bytes)
    t = rec[:, :8].copy().view("<i8").ravel()
    rng = rec[:, 8:].copy().view("<f4").reshape(k, n_rays)
    return t, rng


def save_hokuyo_packets(path, t_us, ranges):
    k, n_rays = ranges.shape
    rec = np.zeros((k, 8 + 4 * n_rays), np.uint8)
    rec[:, :8] = np.asarray(t_us, "<i8").view(np.uint8).reshape(k, 8)
    rec[:, 8:] = np.asarray(ranges, "<f4").view(np.uint8).reshape(k, -1)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    rec.tofile(path)
    return path


def hokuyo_to_points(ranges, angle_span: float = np.deg2rad(270.0),
                     r_min: float = 0.1, r_max: float = 30.0):
    """Planar ranges (R,) -> (R, 2) points in the sensor frame + validity."""
    n = ranges.shape[-1]
    ang = np.linspace(-angle_span / 2, angle_span / 2, n)
    pts = np.stack([ranges * np.cos(ang), ranges * np.sin(ang)], -1)
    valid = (ranges > r_min) & (ranges < r_max)
    return pts, valid
