"""IMU preintegration (``nclt_slam_tpu/vio/preintegration.py``).

Accumulates the frame-relative deltas (ΔR as a quaternion, Δv, Δp) over the
200 Hz sample block between two vision frames, which the VIO propagation
consumes.  Tensors carry a leading route dimension; the per-sample rotation
increments ``so3_exp(w dt)`` are computed for the whole block at once, the
ΔR/Δv/Δp recurrence is a loop over the samples.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from refsim.core.quat import quat_mul, quat_rotate, so3_exp


class Preintegrated(NamedTuple):
    dq: torch.Tensor     # (B, 4) ΔR as quaternion (frame i -> current)
    dv: torch.Tensor     # (B, 3) Δ velocity in frame i coords (gravity-free)
    dp: torch.Tensor     # (B, 3) Δ position in frame i coords (gravity-free)
    dt: torch.Tensor     # (B,) total time


def empty_preint(batch: int, device) -> Preintegrated:
    """The identity deltas of ``batch`` routes on ``device``."""
    dq = torch.zeros(batch, 4, device=device)
    dq[:, 3] = 1.0
    return Preintegrated(dq=dq, dv=torch.zeros(batch, 3, device=device),
                         dp=torch.zeros(batch, 3, device=device),
                         dt=torch.zeros(batch, device=device))


def integrate_block(pre: Preintegrated, accel, gyro, dt: float,
                    bias_acc=None, bias_gyro=None) -> Preintegrated:
    """Integrate a block of IMU samples: accel, gyro (B, S, 3) specific
    force and body rate, ``dt`` per sample.  Gravity is re-added at
    propagation time."""
    if bias_acc is not None:
        accel = accel - bias_acc[:, None]
    if bias_gyro is not None:
        gyro = gyro - bias_gyro[:, None]
    dq_step = so3_exp(gyro * dt)                           # (B, S, 4)
    dq, dv, dp, t = pre
    for k in range(accel.shape[1]):
        a_i = quat_rotate(dq, accel[:, k])
        dp = dp + dv * dt + 0.5 * a_i * dt * dt
        dv = dv + a_i * dt
        dq = quat_mul(dq, dq_step[:, k])
        dq = dq / torch.sqrt((dq * dq).sum(-1, keepdim=True))
        t = t + dt
    return Preintegrated(dq=dq, dv=dv, dp=dp, dt=t)


def propagate(pos_i, vel_i, q_i, pre: Preintegrated, gravity):
    """World-frame state propagation with a preintegrated delta.  q_i
    (B, 4) world_from_body at frame i; gravity (3,) free-fall acceleration
    (the accelerometer measures a_world - g)."""
    dp_w = quat_rotate(q_i, pre.dp)
    dv_w = quat_rotate(q_i, pre.dv)
    dt = pre.dt[:, None]
    pos_j = pos_i + vel_i * dt + 0.5 * gravity * dt ** 2 + dp_w
    vel_j = vel_i + gravity * dt + dv_w
    q_j = quat_mul(q_i, pre.dq)
    return pos_j, vel_j, q_j / torch.sqrt((q_j * q_j).sum(-1, keepdim=True))
