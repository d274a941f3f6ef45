"""Analytic depth raycaster — the RGB-D sensor model
(``nclt_slam_tpu/sensors/depth.py``).

Rays from a D435i-like pinhole camera are intersected with the closed-form
terrain (band-restricted coarse/fine march; with ``CameraConfig.
ray_terrain_tex`` on its baked bilinear texture) and with the scene colliders as
vertical cylinders (exact quadratic), all as dense tensor math over the
decimated ray grid with a leading route dimension.

Camera convention: OpenCV optical frame (x right, y down, z forward);
base_link is FLU.
"""

from __future__ import annotations

import torch

from nclt_slam_tpu_torch.config import CameraConfig
from nclt_slam_tpu_torch.scene.terrain import terrain_height, terrain_height_tex

# base_link (FLU) -> OpenCV camera axes: p_cam = p_base @ R_BASE_CAM
R_BASE_CAM = ((0.0, 0.0, 1.0),
              (-1.0, 0.0, 0.0),
              (0.0, -1.0, 0.0))


def base_to_cam(p):
    """``p @ R_BASE_CAM`` for points (..., 3): an exact axis permutation."""
    return torch.stack([-p[..., 1], -p[..., 2], p[..., 0]], -1)


def cam_to_base(p):
    """``p @ R_BASE_CAM.T`` for points (..., 3)."""
    return torch.stack([p[..., 2], -p[..., 0], -p[..., 1]], -1)


def _rotate(R, p):
    """R (B, 3, 3) applied to points p (B, ..., 3), summed in j order."""
    shape = (R.shape[0],) + (1,) * (p.dim() - 2)
    rows = []
    for i in range(3):
        acc = R[:, i, 0].reshape(shape) * p[..., 0]
        acc = acc + R[:, i, 1].reshape(shape) * p[..., 1]
        acc = acc + R[:, i, 2].reshape(shape) * p[..., 2]
        rows.append(acc)
    return torch.stack(rows, -1)


def camera_pose(base_pos, yaw, cfg: CameraConfig):
    """World camera origin (B, 3) + world_from_cam rotation (B, 3, 3)
    (yaw-aligned, like the reference's camera rig)."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    zero = torch.zeros_like(c)
    origin = base_pos + torch.stack([cfg.cam_offset_fwd * c,
                                     cfg.cam_offset_fwd * s,
                                     zero + cfg.cam_offset_up], -1)
    # R_world_base @ R_BASE_CAM (columns = the optical axes in world
    # coords); its entries are 0/+-1, so the product is exact
    R = torch.stack([torch.stack([s, zero, c], -1),
                     torch.stack([-c, zero, s], -1),
                     torch.stack([zero, zero - 1.0, zero], -1)], -2)
    return origin, R


def ray_grid(cfg: CameraConfig, device):
    """Decimated pixel grid -> unit ray directions in the optical frame
    (rows, cols, 3)."""
    us = (torch.arange(cfg.ray_cols, dtype=torch.float32, device=device)
          + 0.5) * (cfg.width / cfg.ray_cols)
    vs = (torch.arange(cfg.ray_rows, dtype=torch.float32, device=device)
          + 0.5) * (cfg.height / cfg.ray_rows)
    x = ((us[None, :] - cfg.cx) / cfg.fx).expand(cfg.ray_rows, cfg.ray_cols)
    y = ((vs[:, None] - cfg.cy) / cfg.fy).expand(cfg.ray_rows, cfg.ray_cols)
    d = torch.stack([x, y, torch.ones_like(x)], -1)
    return d / torch.sqrt((d * d).sum(-1, keepdim=True))


# terrain_height is clamped to >= -0.5 and its octave amplitudes sum to
# ~1.28, so every surface point lies in this altitude band (+margin)
_TERR_Z_MIN = -0.55
_TERR_Z_MAX = 1.35


def _terrain_hit(origin, dirs_w, cfg: CameraConfig):
    """First ray-terrain crossing: clip each ray to the terrain altitude
    band, coarse-march it, fine-march the first bracketing coarse cell.
    origin (B, 3); dirs_w (B, R, C, 3).  Returns t (B, R, C), inf = miss."""
    S_COARSE = max(8, cfg.ray_steps // 4)
    S_FINE = 8
    # baked-texture path (CameraConfig.ray_terrain_tex): bilinear gathers
    # replace the analytic transcendentals in the march
    h_fn = terrain_height_tex if cfg.ray_terrain_tex else terrain_height
    sh = (origin.shape[0],) + (1,) * (dirs_w.dim() - 2)
    ox, oy, oz = (origin[:, i].reshape(sh) for i in range(3))
    dz = dirs_w[..., 2]
    safe_dz = torch.where(dz.abs() < 1e-4, torch.full_like(dz, 1e-4), dz)
    t1 = (_TERR_Z_MAX - oz) / safe_dz
    t2 = (_TERR_Z_MIN - oz) / safe_dz
    t_en = torch.minimum(t1, t2)
    t_ex = torch.maximum(t1, t2)
    horiz = dz.abs() < 1e-3
    inside = (oz >= _TERR_Z_MIN) & (oz <= _TERR_Z_MAX)
    dmin = torch.full_like(dz, cfg.depth_min)
    dmax = torch.full_like(dz, cfg.depth_max)
    t_lo = torch.where(horiz, dmin, t_en.clamp(cfg.depth_min, cfg.depth_max))
    t_hi = torch.where(horiz, torch.where(inside, dmax, dmin),
                       t_ex.clamp(cfg.depth_min, cfg.depth_max))
    t_hi = torch.maximum(t_hi, t_lo)

    dx, dy, dzw = dirs_w[..., 0], dirs_w[..., 1], dirs_w[..., 2]

    def first_below(t0, step, n):
        """March n samples at t0 + step*(k+0.5); return (hit, k_first)."""
        ks = (torch.arange(n, dtype=torch.float32, device=t0.device)
              + 0.5).reshape((n,) + (1,) * t0.dim())
        ts = t0[None] + step[None] * ks
        px = ox[None] + ts * dx[None]
        py = oy[None] + ts * dy[None]
        pz = oz[None] + ts * dzw[None]
        below = (pz < h_fn(px, py)) & (step[None] > 0)
        return below.any(0), below.to(torch.uint8).argmax(0)

    step_c = (t_hi - t_lo) / S_COARSE
    hit_c, k_c = first_below(t_lo, step_c, S_COARSE)
    cell_lo = t_lo + k_c.to(torch.float32) * step_c
    step_f = step_c / S_FINE
    hit_f, k_f = first_below(cell_lo, step_f, S_FINE)
    t_hit = cell_lo + (k_f.to(torch.float32) + 0.5) * step_f - 0.5 * step_f
    any_hit = hit_c & hit_f & (t_hit <= cfg.depth_max)
    return torch.where(any_hit, t_hit, torch.full_like(t_hit, float("inf")))


def _cylinder_hit(origin, dirs_w, obs_xy, obs_r, obs_base_z, obs_h,
                  obs_valid, cfg: CameraConfig):
    """Exact ray/vertical-cylinder intersection, min over colliders.
    origin (B, 3); dirs_w (B, R, C, 3); obs_* (B, N)."""
    d = dirs_w[..., :2]                                     # (B, R, C, 2)
    a = (d * d).sum(-1)                                     # (B, R, C)
    rel = origin[:, None, :2] - obs_xy                      # (B, N, 2)
    b = 2.0 * (d[..., None, 0] * rel[:, None, None, :, 0]
               + d[..., None, 1] * rel[:, None, None, :, 1])   # (B, R, C, N)
    c0 = ((rel * rel).sum(-1) - obs_r * obs_r)[:, None, None, :]
    disc = b * b - 4.0 * a[..., None] * c0
    sqrt_disc = torch.sqrt(disc.clamp_min(0.0))
    t = (-b - sqrt_disc) / (2.0 * a[..., None] + 1e-12)
    z_hit = origin[:, 2, None, None, None] + t * dirs_w[..., 2:3]
    in_height = (z_hit >= obs_base_z[:, None, None, :]) & \
        (z_hit <= (obs_base_z + obs_h)[:, None, None, :])
    ok = (disc > 0.0) & (t > cfg.depth_min) & in_height & \
        obs_valid[:, None, None, :]
    t = torch.where(ok, t, torch.full_like(t, float("inf")))
    return t.amin(-1)


def render_depth(base_pos, yaw, obs_xy, obs_r, obs_base_z, obs_h, obs_valid,
                 cfg: CameraConfig):
    """Depth image over the decimated ray grid.

    Returns (depth_z (B, R, C) — z-depth in the optical frame;
    points_world (B, R, C, 3); valid mask (B, R, C))."""
    origin, R_wc = camera_pose(base_pos, yaw, cfg)
    dirs_c = ray_grid(cfg, base_pos.device)
    dirs_w = _rotate(R_wc, dirs_c[None])

    t_terr = _terrain_hit(origin, dirs_w, cfg)
    t_cyl = _cylinder_hit(origin, dirs_w, obs_xy, obs_r, obs_base_z, obs_h,
                          obs_valid, cfg)
    t = torch.minimum(t_terr, t_cyl)
    valid = torch.isfinite(t) & (t <= cfg.depth_max)
    t_safe = torch.where(valid, t, torch.full_like(t, cfg.depth_max))

    points_world = origin[:, None, None, :] + t_safe[..., None] * dirs_w
    depth_z = t_safe * dirs_c[..., 2]     # project range onto optical axis
    return torch.where(valid, depth_z, torch.zeros_like(depth_z)), \
        points_world, valid


def depth_to_cam_points(depth_z, cfg: CameraConfig):
    """Depth image (B, R, C) -> points in the optical camera frame."""
    dirs_c = ray_grid(cfg, depth_z.device)
    t = depth_z / dirs_c[..., 2].clamp_min(1e-6)
    return t[..., None] * dirs_c


def cam_points_to_world(p_cam, base_pos, yaw, cfg: CameraConfig):
    """Camera-frame points (B, ..., 3) -> world frame for a given (possibly
    estimated) base pose — the Nav2 costmap's TF transform through the NAV
    pose."""
    origin, R_wc = camera_pose(base_pos, yaw, cfg)
    shape = (origin.shape[0],) + (1,) * (p_cam.dim() - 2) + (3,)
    return _rotate(R_wc, p_cam) + origin.reshape(shape)
