"""Wavefront global planner — the NavFn/A* equivalent
(``nclt_slam_tpu/planning/wavefront.py``).

The potential field comes from iterated 8-neighbour min-plus relaxation
over a fixed local window (``ops.wavefront.wavefront_relax``: the CUDA
kernel on the card), then the path is extracted by steepest descent.
Costs enter the NavFn way: step_cost = dist * (1 + w * cell_cost); lethal
cells (>= 99) are impassable.  Every function takes a leading route
dimension.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from refsim.config import MapConfig, PlannerConfig
from refsim.ops.wavefront import BIG, DIAG, wavefront_relax

_OFFS = [(dr, dc) for dr in (-1, 0, 1) for dc in (-1, 0, 1)
         if (dr, dc) != (0, 0)]


class PlanResult(NamedTuple):
    path_xy: torch.Tensor     # (B, path_len, 2) (padded with last)
    n_path: torch.Tensor      # (B,) int32 — valid prefix length
    ok: torch.Tensor          # (B,) bool — goal potential finite at start
    potential: torch.Tensor   # (B, window, window)


def _rows(x):
    return torch.arange(x.shape[0], device=x.device)


def _fma32(a, b, c):
    """``a * b + c`` of float32 tensors rounded once, as the JAX package's
    compiled descent computes it (XLA contracts the multiply and the add
    into one fused multiply-add; two float32 roundings break the diagonal
    against the straight step differently on open ground).  The product is
    exact in float64, the sum is rounded to odd there (TwoSum's error
    nudges an inexact even result one ulp toward it), and rounding that to
    float32 is then the correctly rounded fused result."""
    a, b, c = a.double(), b.double(), c.double()
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, -float("inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def plan_window(cost, start_rc, goal_rc, map_cfg: MapConfig,
                cfg: PlannerConfig, border_phi=None) -> PlanResult:
    """Plan inside (B, W, W) cost crops.

    start_rc/goal_rc are ((B,), (B,)) int cell coords *within the window*.
    ``border_phi`` (B, W, W), when given, seeds the relaxation with
    cost-to-goal values on the window border (BIG elsewhere).  Returns the
    path in window cell coordinates."""
    W = cfg.window
    res = map_cfg.resolution
    B = cost.shape[0]
    rows = _rows(cost)

    lethal = cost >= cfg.lethal_cost
    tc = res * (1.0 + cfg.cost_weight * cost)
    tc = torch.where(lethal, torch.full_like(tc, BIG), tc)

    gr, gc = (x.long() for x in goal_rc)
    phi0 = torch.full((B, W, W), BIG, dtype=torch.float32, device=cost.device)
    phi0[rows, gr, gc] = 0.0
    if border_phi is not None:
        phi0 = torch.minimum(phi0, border_phi)

    n_iter = cfg.sweeps * W  # each Jacobi sweep propagates one ring
    phi = wavefront_relax(tc, phi0, n_iter)

    sr, sc = (x.long() for x in start_rc)
    ok = phi[rows, sr, sc] < BIG

    # descent extraction from the start cell: the optimal next cell
    # minimises phi[n] + scale(n) * tc[x] (the Bellman equation's argmin),
    # fused as the JAX package's compiled step fuses it
    offs = torch.tensor(_OFFS, dtype=torch.int64, device=cost.device)
    step_scale = torch.tensor([DIAG if (dr and dc) else 1.0
                               for dr, dc in _OFFS],
                              dtype=torch.float32, device=cost.device)
    r, c, done = sr, sc, ~ok
    pr, pc, live = [], [], []
    for _ in range(cfg.path_len):
        nr = (r[:, None] + offs[:, 0]).clamp(0, W - 1)
        nc = (c[:, None] + offs[:, 1]).clamp(0, W - 1)
        vals = _fma32(step_scale, tc[rows, r, c][:, None],
                      phi[rows[:, None], nr, nc])
        k = vals.argmin(1)
        r2 = nr[rows, k]
        c2 = nc[rows, k]
        at_goal = (r2 == gr) & (c2 == gc)
        # border-clipped neighbours can alias the current cell
        stuck = ((r2 == r) & (c2 == c)) | \
            (phi[rows, r2, c2] >= phi[rows, r, c])
        live.append(~done)
        r = torch.where(done, r, r2)
        c = torch.where(done, c, c2)
        pr.append(r)
        pc.append(c)
        done = done | at_goal | stuck
    n_path = torch.stack(live, 1).sum(1).to(torch.int32)
    path_rc = torch.stack([torch.stack(pr, 1), torch.stack(pc, 1)],
                          -1).to(torch.float32)
    return PlanResult(path_xy=path_rc, n_path=n_path, ok=ok, potential=phi)


def coarse_traversal(teach_grid, map_cfg: MapConfig, cfg: PlannerConfig):
    """Static full-map traversal-cost field at ``coarse_factor`` x coarser
    resolution (two-level planning, level 1).  Occupied coarse cells are
    lethal; a one-cell dilation (wrapping, as in the JAX package) stands
    in for the inflation layer.  teach_grid (B, rows, cols) int8."""
    f = cfg.coarse_factor
    occ = teach_grid == 2
    B, rows, cols = occ.shape
    Rp = -(-rows // f) * f
    Cp = -(-cols // f) * f
    occ = torch.nn.functional.pad(occ, (0, Cp - cols, 0, Rp - rows))
    occ8 = occ.reshape(B, Rp // f, f, Cp // f, f).any(4).any(2)
    near = occ8
    for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        near = near | torch.roll(occ8, (dr, dc), (1, 2))
    cost = torch.where(occ8, torch.full(occ8.shape, 100.0, device=occ8.device),
                       torch.where(near,
                                   torch.full(occ8.shape, 50.0,
                                              device=occ8.device),
                                   torch.zeros(occ8.shape,
                                               device=occ8.device)))
    tc = (f * map_cfg.resolution) * (1.0 + cfg.cost_weight * cost)
    return torch.where(occ8, torch.full_like(tc, BIG), tc)


def coarse_potential(tc_coarse, goal_xy, map_cfg: MapConfig,
                     cfg: PlannerConfig):
    """Full-map cost-to-goal potential on the coarse grid (level-1 plan).
    tc_coarse (B, Rc, Cc); goal_xy (B, 2)."""
    B, Rc, Cc = tc_coarse.shape
    res_c = cfg.coarse_factor * map_cfg.resolution
    gc = ((goal_xy[:, 0] - map_cfg.origin_x) / res_c).clamp(0, Cc - 1).long()
    gr = ((goal_xy[:, 1] - map_cfg.origin_y) / res_c).clamp(0, Rc - 1).long()
    phi0 = torch.full((B, Rc, Cc), BIG, dtype=torch.float32,
                      device=tc_coarse.device)
    phi0[_rows(tc_coarse), gr, gc] = 0.0
    return wavefront_relax(tc_coarse, phi0, cfg.coarse_iters)


def _border_seed(coarse_phi, win_r0, win_c0, map_cfg: MapConfig,
                 cfg: PlannerConfig):
    """(B, W, W) seed: coarse cost-to-goal sampled on the window border
    ring, BIG elsewhere."""
    W = cfg.window
    f = cfg.coarse_factor
    B, Rc, Cc = coarse_phi.shape
    ar = torch.arange(W, device=coarse_phi.device)
    rr = torch.div(ar[None, :] + win_r0.long()[:, None], f,
                   rounding_mode="floor").clamp(0, Rc - 1)
    cc = torch.div(ar[None, :] + win_c0.long()[:, None], f,
                   rounding_mode="floor").clamp(0, Cc - 1)
    vals = coarse_phi[_rows(coarse_phi)[:, None, None], rr[:, :, None],
                      cc[:, None, :]]
    border = (ar[:, None] % (W - 1) == 0) | (ar[None, :] % (W - 1) == 0)
    return torch.where(border, vals, torch.full_like(vals, BIG))


def plan_world(cost_window, win_r0, win_c0, start_xy, goal_xy,
               map_cfg: MapConfig, cfg: PlannerConfig,
               coarse_phi=None, coarse_goal=None) -> PlanResult:
    """World-coordinate wrapper: clamps the goal into the window (like Nav2
    planning to the costmap edge toward an out-of-window goal).

    ``coarse_phi``/``coarse_goal``: level-1 full-map potential + the goal it
    was computed for; the border seed applies only while the current goal
    is within 2 m of it (a stale potential falls back to window planning).
    """
    W = cfg.window
    res = map_cfg.resolution

    def to_win(xy):
        c = (xy[:, 0] - map_cfg.origin_x) / res - win_c0
        r = (xy[:, 1] - map_cfg.origin_y) / res - win_r0
        return (r.clamp(0, W - 1).to(torch.int32),
                c.clamp(0, W - 1).to(torch.int32))

    start_rc = to_win(start_xy)
    goal_rc = to_win(goal_xy)
    border_phi = None
    if coarse_phi is not None:
        seed = _border_seed(coarse_phi, win_r0, win_c0, map_cfg, cfg)
        dg = goal_xy - coarse_goal
        fresh = torch.sqrt((dg * dg).sum(-1)) < 2.0
        border_phi = torch.where(fresh[:, None, None], seed,
                                 torch.full_like(seed, BIG))
    res_plan = plan_window(cost_window, start_rc, goal_rc, map_cfg, cfg,
                           border_phi=border_phi)

    # window cells -> world coords
    wx = map_cfg.origin_x + (res_plan.path_xy[..., 1]
                             + win_c0[:, None] + 0.5) * res
    wy = map_cfg.origin_y + (res_plan.path_xy[..., 0]
                             + win_r0[:, None] + 0.5) * res
    path_world = torch.stack([wx, wy], -1)
    # pad the tail with the last valid point
    idx = torch.minimum(
        torch.arange(cfg.path_len, device=wx.device)[None, :],
        (res_plan.n_path.long() - 1).clamp_min(0)[:, None])
    path_world = path_world[_rows(wx)[:, None], idx]
    return PlanResult(path_xy=path_world, n_path=res_plan.n_path,
                      ok=res_plan.ok, potential=res_plan.potential)
