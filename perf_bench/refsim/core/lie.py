"""SE(2)/SE(3) group operations on tensors (``nclt_slam_tpu/core/lie.py``).

Conventions:
- SE(2) pose = tensor ``[x, y, theta]``.
- SE(3) pose = 4x4 homogeneous matrix (acts on column vectors).
- All functions broadcast over leading batch dimensions.
"""

from __future__ import annotations

import torch


def wrap_angle(theta):
    """Wrap angle(s) to (-pi, pi]."""
    return torch.atan2(torch.sin(theta), torch.cos(theta))


def se2_from_xytheta(x, y, theta):
    x, y, theta = torch.broadcast_tensors(
        *(torch.as_tensor(v, dtype=torch.float32) for v in (x, y, theta)))
    return torch.stack([x, y, theta], -1)


def se2_compose(a, b):
    """a ∘ b: first apply b, then a (frame composition T_a @ T_b)."""
    ax, ay, at = a.unbind(-1)
    bx, by, bt = b.unbind(-1)
    c, s = torch.cos(at), torch.sin(at)
    return torch.stack([ax + c * bx - s * by, ay + s * bx + c * by,
                        wrap_angle(at + bt)], -1)


def se2_inverse(a):
    ax, ay, at = a.unbind(-1)
    c, s = torch.cos(at), torch.sin(at)
    return torch.stack([-(c * ax + s * ay), -(-s * ax + c * ay),
                        wrap_angle(-at)], -1)


def se2_apply(a, pts):
    """Apply SE(2) pose ``a`` to point(s) ``pts`` of shape (..., 2)."""
    c, s = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    px, py = pts[..., 0], pts[..., 1]
    return torch.stack([a[..., 0] + c * px - s * py,
                        a[..., 1] + s * px + c * py], -1)


def se3_from_rt(R, t):
    """Build 4x4 from rotation (..., 3, 3) and translation (..., 3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    T = torch.zeros(batch + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def se3_compose(a, b):
    return torch.matmul(a, b)


def se3_inverse(T):
    """Closed-form rigid inverse: (R^T, -R^T t)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    ti = -torch.matmul(Rt, T[..., :3, 3:4])[..., 0]
    return se3_from_rt(Rt, ti)


def se3_apply(T, pts):
    """Apply 4x4 transform(s) to points of shape (..., 3)."""
    return torch.matmul(T[..., :3, :3], pts[..., None])[..., 0] + T[..., :3, 3]
