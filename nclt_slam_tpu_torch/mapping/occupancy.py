"""Log-odds occupancy mapping as tensor scatter ops
(``nclt_slam_tpu/mapping/occupancy.py``).

Every depth ray contributes a fixed number of uniformly spaced free-space
samples plus its endpoint; all updates land in one scatter-add into a live
window around the camera.  Same log-odds constants (L_FREE −0.4, L_OCC
+1.4, clamp ±5, thresholds 0.65/0.25) and 0.1 m resolution as the
reference; grids carry a leading route dimension.
"""

from __future__ import annotations

import torch

from nclt_slam_tpu_torch.config import MapConfig
from nclt_slam_tpu_torch.scene.terrain import terrain_height

FREE_SAMPLES = 24   # free-space samples per ray (Bresenham replacement)


def empty_grid(cfg: MapConfig, batch: int, device):
    return torch.zeros(batch, cfg.rows, cfg.cols, dtype=torch.float32,
                       device=device)


def world_to_cell(x, y, cfg: MapConfig):
    c = torch.floor((x - cfg.origin_x) / cfg.resolution).to(torch.int32)
    r = torch.floor((y - cfg.origin_y) / cfg.resolution).to(torch.int32)
    return r, c


def _window_index(r0, c0, h: int, w: int):
    """(rows (B, h, 1), cols (B, 1, w)) int64 indices of a per-route crop
    whose top-left corner is (r0, c0)."""
    dev = r0.device
    rows = r0.long()[:, None, None] + torch.arange(h, device=dev)[None, :, None]
    cols = c0.long()[:, None, None] + torch.arange(w, device=dev)[None, None, :]
    return rows, cols


def integrate_depth(grid, cam_xy, points_world, points_valid, cfg: MapConfig):
    """One depth frame -> log-odds update (returns a new grid).

    grid (B, rows, cols); cam_xy (B, 2); points_world (B, N, 3) ray
    endpoints in world frame; points_valid (B, N).  The obstacle band is
    measured relative to the local terrain surface.  The scatter-add sums
    in another order than XLA's, so cells agree to float32 rounding.
    """
    pts = points_world[:, :: cfg.point_subsample]
    val = points_valid[:, :: cfg.point_subsample]

    ground = terrain_height(pts[..., 0], pts[..., 1])
    rel_h = pts[..., 2] - ground
    dxy = pts[..., :2] - cam_xy[:, None, :]
    in_range = torch.sqrt((dxy * dxy).sum(-1)) <= cfg.obstacle_range
    occ_mask = val & (rel_h > cfg.height_lo) & (rel_h < cfg.height_hi) & in_range
    # rays that hit low ground still clear free space along their length
    clear_mask = val & in_range

    # all evidence lies within obstacle_range of the camera: scatter into a
    # (LW, LW) crop around it and write the crop back
    LW = min(cfg.live_window, cfg.rows, cfg.cols)
    if LW * cfg.resolution < 2.0 * cfg.obstacle_range:
        raise ValueError(
            f"live_window {LW} cells x {cfg.resolution} m does not cover "
            f"2 x obstacle_range ({cfg.obstacle_range} m)")
    B = grid.shape[0]
    r_cam, c_cam = world_to_cell(cam_xy[:, 0], cam_xy[:, 1], cfg)
    r0 = (r_cam - LW // 2).clamp(0, cfg.rows - LW)
    c0 = (c_cam - LW // 2).clamp(0, cfg.cols - LW)
    rows, cols = _window_index(r0, c0, LW, LW)
    bidx = torch.arange(B, device=grid.device)[:, None, None]
    win = grid[bidx, rows, cols]

    def to_win(r, c):
        rw = r - r0.reshape((B,) + (1,) * (r.dim() - 1))
        cw = c - c0.reshape((B,) + (1,) * (c.dim() - 1))
        ok = (rw >= 0) & (rw < LW) & (cw >= 0) & (cw < LW)
        return rw, cw, ok

    # endpoint scatter (occupied)
    r_end, c_end = world_to_cell(pts[..., 0], pts[..., 1], cfg)
    rw_e, cw_e, okw_e = to_win(r_end, c_end)
    ok_end = occ_mask & okw_e
    idx_end = torch.where(ok_end, rw_e * LW + cw_e, torch.zeros_like(rw_e))
    upd = torch.zeros(B, LW * LW, dtype=torch.float32, device=grid.device)
    upd.scatter_add_(1, idx_end.long(), torch.where(
        ok_end, torch.full_like(rel_h, cfg.l_occ), torch.zeros_like(rel_h)))

    # free-space samples strictly before the endpoint
    fr = (torch.arange(FREE_SAMPLES, dtype=torch.float32, device=grid.device)
          + 0.5) / (FREE_SAMPLES + 1.0)
    sample_xy = cam_xy[:, None, None, :] + fr[None, None, :, None] * (
        pts[:, :, None, :2] - cam_xy[:, None, None, :])
    r_s, c_s = world_to_cell(sample_xy[..., 0], sample_xy[..., 1], cfg)
    rw_s, cw_s, okw_s = to_win(r_s, c_s)
    ok_s = clear_mask[..., None] & okw_s
    idx_s = torch.where(ok_s, rw_s * LW + cw_s, torch.zeros_like(rw_s))
    l_free = cfg.l_free * (8.0 / FREE_SAMPLES)
    upd.scatter_add_(1, idx_s.reshape(B, -1).long(), torch.where(
        ok_s, torch.full(ok_s.shape, l_free, device=grid.device),
        torch.zeros(ok_s.shape, device=grid.device)).reshape(B, -1))

    win = (win + upd.reshape(B, LW, LW)).clamp(cfg.l_min, cfg.l_max)
    out = grid.clone()
    out[bidx, rows, cols] = win
    return out


def occupancy_trinary(grid, cfg: MapConfig):
    """Log-odds -> {0: free, 1: unknown, 2: occupied} like the PGM trinary."""
    occ_th, free_th = torch.log(torch.tensor(
        [cfg.occ_thresh / (1.0 - cfg.occ_thresh),
         cfg.free_thresh / (1.0 - cfg.free_thresh)],
        dtype=torch.float32)).tolist()
    out = torch.ones_like(grid, dtype=torch.int8)
    out = torch.where(grid < free_th, torch.zeros_like(out), out)
    return torch.where(grid > occ_th, torch.full_like(out, 2), out)


def crop_window(grid, center_r, center_c, window: int):
    """Fixed-size window crop centred at (r, c) per route, clamped to the
    grid.  Returns (crop (B, window, window), r0 (B,), c0 (B,))."""
    rows, cols = grid.shape[-2:]
    r0 = (center_r - window // 2).clamp(0, rows - window)
    c0 = (center_c - window // 2).clamp(0, cols - window)
    ri, ci = _window_index(r0, c0, window, window)
    bidx = torch.arange(grid.shape[0], device=grid.device)[:, None, None]
    return grid[bidx, ri, ci], r0, c0


def inflate_cost(occ_window, cfg: MapConfig):
    """Costmap from a trinary window (B, W, W): lethal at obstacles,
    exponential decay within the inflation radius (Nav2 inflation_layer
    semantics).  Distance via iterated 3x3 min-plus (wrapping rolls, as in
    the JAX package)."""
    n_iter = int(round((cfg.inflation_radius + cfg.inscribed_radius)
                       / cfg.resolution)) + 1
    dist = torch.where(occ_window == 2,
                       torch.zeros(occ_window.shape, device=occ_window.device),
                       torch.full(occ_window.shape, 1e6,
                                  device=occ_window.device))
    diag = 1.4142135 * cfg.resolution
    orth = cfg.resolution
    for _ in range(n_iter):
        d = dist
        dn = d
        dn = torch.minimum(dn, torch.roll(d, 1, 1) + orth)
        dn = torch.minimum(dn, torch.roll(d, -1, 1) + orth)
        dn = torch.minimum(dn, torch.roll(d, 1, 2) + orth)
        dn = torch.minimum(dn, torch.roll(d, -1, 2) + orth)
        dn = torch.minimum(dn, torch.roll(d, (1, 1), (1, 2)) + diag)
        dn = torch.minimum(dn, torch.roll(d, (1, -1), (1, 2)) + diag)
        dn = torch.minimum(dn, torch.roll(d, (-1, 1), (1, 2)) + diag)
        dn = torch.minimum(dn, torch.roll(d, (-1, -1), (1, 2)) + diag)
        dist = dn
    cost = 98.0 * torch.exp(
        -cfg.cost_scaling * torch.clamp_min(dist - cfg.inscribed_radius, 0.0))
    cost = torch.where(dist <= cfg.inscribed_radius,
                       torch.full_like(cost, 99.0), cost)
    return torch.where(dist <= cfg.inflation_radius + cfg.inscribed_radius,
                       cost, torch.zeros_like(cost))
