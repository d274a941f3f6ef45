"""Analytic forest terrain heightfield (``nclt_slam_tpu/scene/terrain.py``).

A closed-form multi-octave sine field with a flattened S-curve road
corridor, evaluated elementwise on float32 tensors of any shape, and its
baked 0.25 m texture sampled bilinearly (``terrain_height_tex``, the
raycaster's ``CameraConfig.ray_terrain_tex`` path).
"""

from __future__ import annotations

import numpy as np
import torch

# Road centreline waypoints (the S-curve the scene is built around);
# piecewise-linear y(x).  Same polyline as the reference scene model.
ROAD_WPS = np.array(
    [
        (-100, -7), (-95, -6), (-90, -4.5), (-85, -2.8), (-80, -1.5),
        (-75, -0.8), (-70, -0.5), (-65, -1), (-60, -2.2), (-55, -3.8),
        (-50, -5), (-45, -5.5), (-40, -5.2), (-35, -4), (-30, -2.5),
        (-25, -1), (-20, 0.2), (-15, 1.2), (-10, 1.8), (-5, 2), (0, 1.5),
        (5, 0.5), (10, -0.8), (15, -2.2), (20, -3.5), (25, -4.2), (30, -4),
        (35, -3), (40, -1.8), (45, -0.8), (50, -0.5), (55, -1), (60, -2),
        (65, -3.2), (70, -4.5), (75, -5),
    ],
    dtype=np.float32,
)
_ROAD_DX = 5.0  # ROAD_WPS x-knots are uniform
_X0 = float(ROAD_WPS[0, 0])
_X1 = float(ROAD_WPS[-1, 0])
_NK = len(ROAD_WPS)


_KNOTS: dict = {}


def _knots(device) -> torch.Tensor:
    """ROAD_WPS as a tensor on ``device`` (copied there once)."""
    if device not in _KNOTS:
        _KNOTS[device] = torch.from_numpy(ROAD_WPS).to(device)
    return _KNOTS[device]


def road_y(x: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear road centreline y(x), clamped at the ends.

    The JAX package sums a hat function over all 36 knots; every hat but
    the (at most two) around ``x`` clips to exactly 0, so the same sum is
    formed here from the three knots around the clamped ``x``, in knot
    order (the third guards the floor's rounding at a knot)."""
    xc = x.clamp(_X0, _X1)
    k = torch.floor((xc - _X0) / _ROAD_DX).to(torch.int64) - 1
    y = torch.zeros_like(xc)
    knots = _knots(x.device)
    for j in range(3):
        kj = k + j
        ok = (kj >= 0) & (kj < _NK)
        kc = kj.clamp(0, _NK - 1)
        w = (1.0 - (xc - knots[kc, 0]).abs() / _ROAD_DX).clamp(0.0, 1.0)
        y = y + torch.where(ok, w, torch.zeros_like(w)) * knots[kc, 1]
    return y


def terrain_height(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Closed-form terrain height, elementwise over any batch shape.

    Multi-octave sine hills + small forest-floor bumps, quadratically
    flattened within 4 m of the road and slightly sunk (6 cm crown) within
    2 m."""
    h = 0.5 * torch.sin(x * 0.018 + 0.5) * torch.cos(y * 0.022 + 1.2)
    h = h + 0.35 * torch.sin(x * 0.035 + 2.1) * torch.sin(y * 0.03 + 0.7)
    h = h + 0.18 * torch.sin(x * 0.07 + 3.3) * torch.cos(y * 0.065 + 2.5)
    h = h + 0.12 * torch.cos(x * 0.11 + 1.0) * torch.sin(y * 0.09 + 4.0)
    h = h + 0.06 * torch.sin(x * 0.5 + 0.7) * torch.cos(y * 0.43 + 2.1)
    h = h + 0.04 * torch.cos(x * 0.7 + 3.5) * torch.sin(y * 0.6 + 0.4)
    h = h + 0.03 * torch.sin(x * 1.0 + 1.2) * torch.cos(y * 0.83 + 3.8)
    road_dist = (y - road_y(x)).abs()
    flatten = torch.where(road_dist < 4.0, (road_dist / 4.0) ** 2,
                          torch.ones_like(road_dist))
    h = h * flatten
    h = h - torch.where(road_dist < 2.0, 0.06 * (1.0 - road_dist / 2.0),
                        torch.zeros_like(road_dist))
    return h.clamp_min(-0.5)


def terrain_normal(x, y, eps: float = 0.2) -> torch.Tensor:
    """Finite-difference surface normal (unit vector, z-up)."""
    hx = (terrain_height(x + eps, y) - terrain_height(x - eps, y)) / (2 * eps)
    hy = (terrain_height(x, y + eps) - terrain_height(x, y - eps)) / (2 * eps)
    n = torch.stack([-hx, -hy, torch.ones_like(hx)], -1)
    return n / torch.sqrt((n * n).sum(-1, keepdim=True))


def terrain_pitch_roll(x, y, yaw, eps: float = 0.3):
    """Robot pitch/roll implied by terrain slope under heading ``yaw``:
    pitch from the along-track slope, roll from the cross-track slope."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    h0 = terrain_height(x, y)
    h_fwd = terrain_height(x + eps * c, y + eps * s)
    h_lat = terrain_height(x - eps * s, y + eps * c)
    eps_t = torch.full_like(h0, eps)
    pitch = torch.atan2(-(h_fwd - h0), eps_t)   # nose-up positive
    roll = torch.atan2(h_lat - h0, eps_t)
    return pitch, roll


# ---- baked bilinear terrain texture (the raycaster's CameraConfig.
# ray_terrain_tex path) ----
#
# The terrain is globally static, so the raycaster may sample a baked
# 0.25 m grid instead of the analytic field; the error stays far below the
# depth sensor's own noise floor.  Dynamics and the pose math keep the
# analytic field.

TEX_RES = 0.25
TEX_X0, TEX_Y0 = -140.0, -100.0
TEX_NX, TEX_NY = 1121, 801            # covers x in [-140, 140], y in [-100, 100]

_TEX_CACHE = None
_TEX_DEV: dict = {}


def _terrain_height_np(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """The terrain formula in numpy, with ``np.interp`` for the road: the
    JAX package's bake (its ``_terrain_height_impl`` on numpy), operation
    for operation, so that the baked bits are the same."""
    h = 0.5 * np.sin(x * 0.018 + 0.5) * np.cos(y * 0.022 + 1.2)
    h += 0.35 * np.sin(x * 0.035 + 2.1) * np.sin(y * 0.03 + 0.7)
    h += 0.18 * np.sin(x * 0.07 + 3.3) * np.cos(y * 0.065 + 2.5)
    h += 0.12 * np.cos(x * 0.11 + 1.0) * np.sin(y * 0.09 + 4.0)
    h += 0.06 * np.sin(x * 0.5 + 0.7) * np.cos(y * 0.43 + 2.1)
    h += 0.04 * np.cos(x * 0.7 + 3.5) * np.sin(y * 0.6 + 0.4)
    h += 0.03 * np.sin(x * 1.0 + 1.2) * np.cos(y * 0.83 + 3.8)
    road = np.interp(x, ROAD_WPS[:, 0], ROAD_WPS[:, 1])
    road_dist = np.abs(y - road)
    flatten = np.where(road_dist < 4.0, (road_dist / 4.0) ** 2, 1.0)
    h = h * flatten
    h = h - np.where(road_dist < 2.0, 0.06 * (1.0 - road_dist / 2.0), 0.0)
    return np.maximum(h, -0.5)


def terrain_tex() -> np.ndarray:
    """Baked (TEX_NY, TEX_NX) float32 height grid (numpy, built once)."""
    global _TEX_CACHE
    if _TEX_CACHE is None:
        xs = TEX_X0 + TEX_RES * np.arange(TEX_NX, dtype=np.float32)
        ys = TEX_Y0 + TEX_RES * np.arange(TEX_NY, dtype=np.float32)
        gx, gy = np.meshgrid(xs, ys)
        _TEX_CACHE = _terrain_height_np(
            gx.astype(np.float32), gy.astype(np.float32)).astype(np.float32)
    return _TEX_CACHE


def _tex(device) -> torch.Tensor:
    """The baked grid as a tensor on ``device`` (copied there once)."""
    if device not in _TEX_DEV:
        _TEX_DEV[device] = torch.from_numpy(terrain_tex()).to(device)
    return _TEX_DEV[device]


def terrain_height_tex(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of the baked grid on the tensors' device
    (coordinates clamped to its bounds); a drop-in for ``terrain_height``
    inside the raycaster."""
    tex = _tex(x.device)
    fx = ((x - TEX_X0) / TEX_RES).clamp(0.0, TEX_NX - 1.001)
    fy = ((y - TEX_Y0) / TEX_RES).clamp(0.0, TEX_NY - 1.001)
    ix = fx.to(torch.int64)
    iy = fy.to(torch.int64)
    ax = fx - ix
    ay = fy - iy
    h00 = tex[iy, ix]
    h01 = tex[iy, ix + 1]
    h10 = tex[iy + 1, ix]
    h11 = tex[iy + 1, ix + 1]
    return (h00 * (1 - ax) * (1 - ay) + h01 * ax * (1 - ay)
            + h10 * (1 - ax) * ay + h11 * ax * ay)
