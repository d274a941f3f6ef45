"""IMU utilities (datasets/nclt_kaggle/src/utils/imu_utils.py:26-297;
``nclt_slam_tpu/datasets/utils/imu_utils.py``): parsing, interpolation,
bias estimation, gravity alignment (numpy), gyro integration and discrete
preintegration (loops over tensors on the port's ``core/quat.py``).

The integrators take numpy arrays or tensors and run on the tensors'
device (numpy inputs on the CPU); they return numpy, as the JAX package's
do.  They reproduce that package's float32 timestamps: its ``jnp.float64``
is float32 with x64 off, so epoch-microsecond stamps (~1.3e15, float32
spacing ~1.3e8 µs) collapse and every ``dt`` of a 10 s session is 0.  The
port keeps that, and does not integrate in float64.
"""

from __future__ import annotations

import numpy as np
import torch

from nclt_slam_tpu_torch.core.quat import quat_mul, quat_rotate, quat_to_mat, so3_exp

US_TO_S = 1e-6


def parse_ms25(stream_data: np.ndarray):
    """ms25 data columns (mag 3, accel 3, gyro 3) -> (mag, accel, gyro)."""
    return stream_data[:, 0:3], stream_data[:, 3:6], stream_data[:, 6:9]


def interpolate_imu(t_us_target, t_us_src, accel, gyro):
    """Linear interpolation of IMU samples onto target timestamps."""
    t, ts = t_us_target.astype(np.float64), t_us_src.astype(np.float64)
    a = np.stack([np.interp(t, ts, accel[:, i]) for i in range(3)], -1)
    g = np.stack([np.interp(t, ts, gyro[:, i]) for i in range(3)], -1)
    return a, g


def estimate_biases(accel, gyro, still_mask=None, gravity: float = 9.80665):
    """Static bias estimation: mean gyro is the gyro bias; accel bias is the
    mean residual after removing the best-fit gravity direction."""
    if still_mask is None:
        still_mask = np.ones(len(accel), bool)
    g_bias = gyro[still_mask].mean(0)
    a_mean = accel[still_mask].mean(0)
    g_dir = a_mean / np.linalg.norm(a_mean)
    a_bias = a_mean - g_dir * gravity
    return a_bias, g_bias


def gravity_align_rotation(accel_mean, gravity_world=(0.0, 0.0, 1.0)):
    """Rotation taking the measured gravity direction onto +z (or the given
    world gravity direction)."""
    a = np.asarray(accel_mean, np.float64)
    a = a / np.linalg.norm(a)
    b = np.asarray(gravity_world, np.float64)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if np.linalg.norm(v) < 1e-9:
        return np.eye(3) if c > 0 else -np.eye(3)
    K = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + K + K @ K * (1.0 / (1.0 + c))


def _device(x):
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


def _f32(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float64)).to(
        device=device, dtype=torch.float32)


def _dt_s(t_us, device):
    """Step lengths in seconds from the stamps cast to float32 (the JAX
    package's effective precision, see the module docstring)."""
    return torch.diff(_f32(t_us, device)) * US_TO_S


def _normalized(q):
    return q / torch.sqrt((q * q).sum(-1))


def integrate_gyro(t_us, gyro):
    """Orientation-only integration (rodrigues chain) -> (N, 3, 3)."""
    dev = _device(gyro)
    dt = _dt_s(t_us, dev)
    w = _f32(gyro, dev)[:-1]
    q = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)
    qs = [q]
    for i in range(len(dt)):
        q2 = quat_mul(q, so3_exp(w[i] * dt[i]))
        q = _normalized(q2)
        qs.append(q2)
    return quat_to_mat(torch.stack(qs)).cpu().numpy()


def imu_preintegration(t_us, accel, gyro, gravity=(0.0, 0.0, -9.81)):
    """Discrete preintegration -> dict(positions, velocities, orientations)
    with the reference's return signature (imu_utils.py:243-297)."""
    dev = _device(accel)
    g = torch.tensor(gravity, dtype=torch.float32, device=dev)
    dt = _dt_s(t_us, dev)
    a = _f32(accel, dev)[:-1]
    w = _f32(gyro, dev)[:-1]
    p = torch.zeros(3, device=dev)
    v = torch.zeros(3, device=dev)
    q = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)
    ps, vs, qs = [p], [v], [q]
    for i in range(len(dt)):
        dti = dt[i]
        a_world = quat_rotate(q, a[i]) + g
        q2 = _normalized(quat_mul(q, so3_exp(w[i] * dti)))
        v2 = v + a_world * dti
        p2 = p + v * dti + 0.5 * a_world * dti * dti
        p, v, q = p2, v2, q2
        ps.append(p)
        vs.append(v)
        qs.append(q)
    return {
        "positions": torch.stack(ps).cpu().numpy(),
        "velocities": torch.stack(vs).cpu().numpy(),
        "orientations": quat_to_mat(torch.stack(qs)).cpu().numpy(),
    }
