"""Quaternion / SO(3) math (xyzw convention, matching scipy + ROS) —
``nclt_slam_tpu/core/quat.py`` on tensors that broadcast over leading
batch dimensions."""

from __future__ import annotations

import torch

_EPS = 1e-12


def quat_from_yaw(yaw: torch.Tensor) -> torch.Tensor:
    """Quaternion [x, y, z, w] for a pure z-rotation."""
    half = 0.5 * yaw
    z = torch.sin(half)
    w = torch.cos(half)
    zero = torch.zeros_like(z)
    return torch.stack([zero, zero, z, w], -1)


def quat_from_axis_angle(axis, angle):
    axis = axis / (torch.sqrt((axis * axis).sum(-1, keepdim=True)) + _EPS)
    half = 0.5 * angle[..., None]
    return torch.cat([axis * torch.sin(half), torch.cos(half)], -1)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product, xyzw."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], -1)


def quat_conj(q):
    return torch.cat([-q[..., :3], q[..., 3:]], -1)


def _cross(a, b):
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], -1)


def skew(y):
    """[y]x for vectors (..., 3) -> (..., 3, 3)."""
    y0, y1, y2 = y.unbind(-1)
    z = torch.zeros_like(y0)
    return torch.stack([z, -y2, y1, y2, z, -y0, -y1, y0, z],
                       -1).reshape(y.shape + (3,))


def quat_rotate(q, v):
    """Rotate vector(s) v (..., 3) by quaternion(s) q (..., 4)."""
    qv = q[..., :3]
    t = 2.0 * _cross(qv, v)
    return v + q[..., 3:4] * t + _cross(qv, t)


def quat_to_yaw(q):
    """Yaw: atan2(2(wz + xy), 1 - 2(y² + z²))."""
    x, y, z, w = q.unbind(-1)
    return torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))


def quat_to_mat(q):
    x, y, z, w = q.unbind(-1)
    n = x * x + y * y + z * z + w * w
    s = torch.where(n > _EPS, 2.0 / n.clamp_min(_EPS), torch.zeros_like(n))
    xx, yy, zz = x * x * s, y * y * s, z * z * s
    xy, xz, yz = x * y * s, x * z * s, y * z * s
    wx, wy, wz = w * x * s, w * y * s, w * z * s
    m = torch.stack([
        1.0 - (yy + zz), xy - wz, xz + wy,
        xy + wz, 1.0 - (xx + zz), yz - wx,
        xz - wy, yz + wx, 1.0 - (xx + yy),
    ], -1)
    return m.reshape(m.shape[:-1] + (3, 3))


def mat_to_quat(R):
    """Rotation matrix -> xyzw quaternion (branch-free Shepperd variant):
    all four candidate constructions, the numerically best one selected."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw2 = (1.0 + tr).clamp_min(0.0)
    qx2 = (1.0 + m00 - m11 - m22).clamp_min(0.0)
    qy2 = (1.0 - m00 + m11 - m22).clamp_min(0.0)
    qz2 = (1.0 - m00 - m11 + m22).clamp_min(0.0)

    def safe_div(a, b):
        return a / torch.where(b.abs() < _EPS, torch.ones_like(b), b)

    sw = torch.sqrt(qw2 + _EPS) * 2.0
    cand_w = torch.stack([safe_div(m21 - m12, sw), safe_div(m02 - m20, sw),
                          safe_div(m10 - m01, sw), 0.25 * sw], -1)
    sx = torch.sqrt(qx2 + _EPS) * 2.0
    cand_x = torch.stack([0.25 * sx, safe_div(m01 + m10, sx),
                          safe_div(m02 + m20, sx), safe_div(m21 - m12, sx)], -1)
    sy = torch.sqrt(qy2 + _EPS) * 2.0
    cand_y = torch.stack([safe_div(m01 + m10, sy), 0.25 * sy,
                          safe_div(m12 + m21, sy), safe_div(m02 - m20, sy)], -1)
    sz = torch.sqrt(qz2 + _EPS) * 2.0
    cand_z = torch.stack([safe_div(m02 + m20, sz), safe_div(m12 + m21, sz),
                          0.25 * sz, safe_div(m10 - m01, sz)], -1)

    # first maximum wins, as jnp.argmax
    best = torch.stack([qw2, qx2, qy2, qz2], -1).argmax(-1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], -2)
    q = torch.gather(cands, -2, best[..., None, None].expand(
        best.shape + (1, 4)))[..., 0, :]
    q = q / (torch.sqrt((q * q).sum(-1, keepdim=True)) + _EPS)
    # canonical sign (w >= 0)
    return q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)


def so3_exp(rotvec):
    """Rotation vector -> quaternion (xyzw)."""
    angle = torch.sqrt((rotvec * rotvec).sum(-1))
    small = angle < 1e-8
    safe = torch.where(small, torch.ones_like(angle), angle)
    q = quat_from_axis_angle(rotvec / safe[..., None], angle)
    # first-order fallback near zero: q ≈ [r/2, 1]
    approx = torch.cat([0.5 * rotvec, torch.ones_like(angle)[..., None]], -1)
    approx = approx / (torch.sqrt((approx * approx).sum(-1, keepdim=True))
                       + _EPS)
    return torch.where(small[..., None], approx, q)


def so3_log(q):
    """Quaternion (xyzw) -> rotation vector."""
    q = q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)
    v = q[..., :3]
    w = q[..., 3].clamp(-1.0, 1.0)
    n = torch.sqrt((v * v).sum(-1))
    angle = 2.0 * torch.atan2(n, w)
    small = n < 1e-8
    scale = torch.where(small, torch.full_like(n, 2.0),
                        angle / torch.where(small, torch.ones_like(n), n))
    return v * scale[..., None]
