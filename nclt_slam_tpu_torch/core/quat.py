"""Quaternion math (xyzw convention, matching scipy + ROS) — the subset of
``nclt_slam_tpu/core/quat.py`` the GT-localized rollout calls."""

from __future__ import annotations

import torch


def quat_from_yaw(yaw: torch.Tensor) -> torch.Tensor:
    """Quaternion [x, y, z, w] for a pure z-rotation."""
    half = 0.5 * yaw
    z = torch.sin(half)
    w = torch.cos(half)
    zero = torch.zeros_like(z)
    return torch.stack([zero, zero, z, w], -1)


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
