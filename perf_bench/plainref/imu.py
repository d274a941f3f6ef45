"""The 200 Hz IMU over one navigation tick's substeps, in float64 NumPy.

For each substep k, from the body's positions p_k and attitudes q_k
(quaternions x, y, z, w): the world velocity is the position difference
over dt, the raw world acceleration the velocity difference over dt; the
body rate is the rotation vector of q_{k-1}^-1 q_k over dt, low-passed as
a new + (1 - a) previous; the acceleration is the mean of the last
``accel_mean_taps`` raw values (fewer while the ring fills); the robot is
still when the ring of its last ``standstill_window`` positions is full
and spans under ``standstill_thresh``, and then the specific force is
gravity alone.  The specific force (mean acceleration plus gravity) is
rotated into the body frame, then white noise (``normal`` of the
substep's key) and the constant biases are added.  A state's very first
sample reads gravity on z and zero rates, and leaves the rate filter, the
velocity and the acceleration ring at zero.
"""

from __future__ import annotations

import numpy as np

from plainref import threefry


def _qmul(a, b):
    ax, ay, az, aw = np.moveaxis(a, -1, 0)
    bx, by, bz, bw = np.moveaxis(b, -1, 0)
    return np.stack([aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw,
                     aw * bw - ax * bx - ay * by - az * bz], -1)


def _conj(q):
    return q * np.array([-1.0, -1.0, -1.0, 1.0])


def _rotate(q, v):
    """v rotated by the unit quaternion q: the vector part of q v q*."""
    v4 = np.concatenate([v, np.zeros(v.shape[:-1] + (1,))], -1)
    return _qmul(_qmul(q, v4), _conj(q))[..., :3]


def _log(q):
    """Rotation vector of q (the shorter rotation)."""
    q = np.where(q[..., 3:] < 0, -q, q)
    n = np.linalg.norm(q[..., :3], axis=-1)
    angle = 2.0 * np.arctan2(n, np.clip(q[..., 3], -1.0, 1.0))
    scale = np.where(n < 1e-8, 2.0, angle / np.where(n < 1e-8, 1.0, n))
    return q[..., :3] * scale[..., None]


def imu_block(state: dict, positions, quats, dt: float, key, cfg) -> dict:
    """``state`` maps the IMU state's fields to arrays (B, ...); returns
    float64 arrays: ``meas`` (B, S, 6) = [accel | gyro] and the new
    state's fields."""
    f = lambda a: np.asarray(a, np.float64)             # noqa: E731
    pos, quat = f(positions), f(quats)
    B, S, _ = pos.shape
    g = np.array([0.0, 0.0, cfg.gravity])
    keys = threefry.split(threefry.split(key, S), 2)      # (B, S, 2, 2)
    noise = threefry.normal(keys, 3)                       # (B, S, 2, 3)
    prev_pos, prev_vel = f(state["prev_pos"]), f(state["prev_vel"])
    prev_q, omega_prev = f(state["prev_quat"]), f(state["prev_omega"])
    buf, acc_n = f(state["accel_buf"]).copy(), np.asarray(state["accel_n"])
    hist, pos_n = f(state["pos_hist"]).copy(), np.asarray(state["pos_n"])
    first = ~np.asarray(state["initialized"], bool)
    taps, win = cfg.accel_mean_taps, cfg.standstill_window
    rows = np.arange(B)
    meas = np.zeros((B, S, 6))
    for k in range(S):
        vel = (pos[:, k] - prev_pos) / dt
        acc = (vel - prev_vel) / dt
        omega = cfg.omega_lpf_new * _log(_qmul(_conj(prev_q), quat[:, k])) \
            / dt + (1.0 - cfg.omega_lpf_new) * omega_prev
        ring = buf.copy()
        ring[rows, acc_n % taps] = acc
        mean = ring.sum(1) / np.minimum(acc_n + 1, taps)[:, None]
        hist[rows, pos_n % win] = pos[:, k]
        oldest = hist[rows, (pos_n + 1) % win]
        span = np.linalg.norm(hist - oldest[:, None], axis=-1).max(1)
        still = (pos_n + 1 >= win) & (span < cfg.standstill_thresh)
        inv = _conj(quat[:, k])
        force = np.where(still[:, None], _rotate(inv, np.broadcast_to(
            g, (B, 3))), _rotate(inv, mean + g))
        accel = force + cfg.accel_std * noise[:, k, 0] + \
            f(state["bias_accel"])
        gyro = omega + cfg.gyro_std * noise[:, k, 1] + f(state["bias_gyro"])
        at_start = first if k == 0 else np.zeros(B, bool)
        accel = np.where(at_start[:, None], g, accel)
        gyro = np.where(at_start[:, None], 0.0, gyro)
        meas[:, k] = np.concatenate([accel, gyro], -1)
        vel = np.where(at_start[:, None], 0.0, vel)
        omega_prev = np.where(at_start[:, None], 0.0, omega)
        buf = np.where(at_start[:, None, None], buf, ring)
        acc_n = np.where(at_start, 0, acc_n + 1)
        pos_n = pos_n + 1
        prev_pos, prev_vel, prev_q = pos[:, k], vel, quat[:, k]
    return {"meas": meas, "prev_pos": prev_pos, "prev_vel": prev_vel,
            "prev_quat": prev_q, "prev_omega": omega_prev,
            "accel_buf": buf, "accel_n": acc_n, "pos_hist": hist,
            "pos_n": pos_n, "bias_gyro": f(state["bias_gyro"]),
            "bias_accel": f(state["bias_accel"]),
            "initialized": np.ones(B, bool)}
