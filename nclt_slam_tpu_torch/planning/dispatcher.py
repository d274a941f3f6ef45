"""Waypoint dispatcher — the send_goals_hybrid.py state machine, maskable
(``nclt_slam_tpu/planning/dispatcher.py``).

Teach WPs subsampled at 4 m; per-costmap-update projection of unsafe WPs
to the nearest low-cost cell (3 m search / 1 m shift cap); look-ahead skip
at cost >= 60 with a detour-ring fallback; replanning through the wavefront
planner; REACH at 3 m; per-WP timeout; plan-fail SKIP; the final-5-WP
policy.  ``dispatch_move`` is the cheap every-tick phase; ``dispatch_plan``
the heavy phase the rollout calls at the costmap cadence.  State carries a
leading route dimension; per-route decisions are ``torch.where`` masks.

``PlannerConfig.stock_follow`` selects the stock Nav2 FollowWaypoints
semantics (a host-side ``if``, like the cadence gates): the WPs are
projected once before the run (``stock_project_waypoints``, on the host),
a lethal believed start or an all-lethal goal-tolerance disc fails the
plan and leaves the follower path-less, and a WP is given up only by the
goal-blocked abort or the plan-fail budget — there is no per-WP timeout.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from nclt_slam_tpu_torch.config import MapConfig, PlannerConfig
from nclt_slam_tpu_torch.planning.wavefront import plan_world


class DispatchState(NamedTuple):
    wps: torch.Tensor             # (B, W, 2) original teach waypoints
    wps_proj: torch.Tensor        # (B, W, 2) current projected targets
    n_wps: torch.Tensor           # (B,) int32
    skip: torch.Tensor            # (B, W) bool — projection failed
    idx: torch.Tensor             # (B,) int32 current WP
    target: torch.Tensor          # (B, 2) current nav target (WP or detour)
    ticks_on_wp: torch.Tensor     # (B,) int32
    plan_fails: torch.Tensor      # (B,) int32
    path_xy: torch.Tensor         # (B, P, 2) current plan
    n_path: torch.Tensor          # (B,) int32
    has_path: torch.Tensor        # (B,) bool
    plan_version: torch.Tensor    # (B,) int32 — bumps on an accepted path
    plan_tick: torch.Tensor       # (B,) int32 — tick of the last accepted path
    planned_target: torch.Tensor  # (B, 2) target of the last accepted path
    reached_count: torch.Tensor   # (B,) int32
    skipped_count: torch.Tensor   # (B,) int32
    done: torch.Tensor            # (B,) bool — all WPs consumed
    goal_blocked: torch.Tensor    # (B,) bool — stock-baseline NavFn failure
    blocked_ticks: torch.Tensor   # (B,) int32


def subsample_waypoints(dense_xy: np.ndarray, n_dense: int,
                        cfg: PlannerConfig):
    """Offline 4 m subsample of the teach path (numpy; feeds fixed arrays):
    keep a point when it is >= spacing from the last kept point."""
    pts = dense_xy[:n_dense]
    keep = [pts[0]]
    for p in pts[1:]:
        if np.hypot(*(p - keep[-1])) >= cfg.wp_spacing_m:
            keep.append(p)
    keep = np.asarray(keep, np.float32)
    n = min(len(keep), cfg.max_waypoints)
    out = np.zeros((cfg.max_waypoints, 2), np.float32)
    out[:n] = keep[:n]
    out[n:] = keep[n - 1]
    return out, n


def stock_project_waypoints(teach_grid: np.ndarray, wps: np.ndarray,
                            n_wps: int, map_cfg,
                            proj_radius_m: float = 2.0,
                            lethal: float = 70.0,
                            free: float = 50.0):
    """One-time client-side WP projection, the stock baseline's only costmap
    awareness (waypoint_follower_client.py:66-163): peek the static teach-map
    costmap at every WP; cost >= LETHAL_INFLATED (70) -> move to the nearest
    cell < 50 within 2 m, or DROP the WP if none exists.  Runs on the host
    (numpy) before the rollout, like the reference client before sending
    the action.

    teach_grid: (R, C) trinary int8.  Returns (wps', n') with dropped WPs
    compacted out and tail-padded like subsample_waypoints.
    """
    from scipy import ndimage

    occ = np.asarray(teach_grid) == 2
    dist = ndimage.distance_transform_edt(~occ) * map_cfg.resolution
    cost = 98.0 * np.exp(-map_cfg.cost_scaling
                         * np.maximum(dist - map_cfg.inscribed_radius, 0.0))
    cost = np.where(dist <= map_cfg.inscribed_radius, 99.0, cost)
    cost = np.where(dist <= map_cfg.inflation_radius + map_cfg.inscribed_radius,
                    cost, 0.0)

    res = map_cfg.resolution
    rad_cells = int(proj_radius_m / res) + 1

    def cost_at(x, y):
        c = int((x - map_cfg.origin_x) / res)
        r = int((y - map_cfg.origin_y) / res)
        if not (0 <= r < cost.shape[0] and 0 <= c < cost.shape[1]):
            return 100.0
        return float(cost[r, c])

    kept = []
    for x, y in np.asarray(wps)[: int(n_wps)]:
        if cost_at(x, y) < lethal:
            kept.append((x, y))
            continue
        best, best_d = None, None
        for dr in range(-rad_cells, rad_cells + 1):
            for dc in range(-rad_cells, rad_cells + 1):
                if dr * dr + dc * dc > rad_cells * rad_cells:
                    continue
                nx, ny = x + dc * res, y + dr * res
                if cost_at(nx, ny) < free:
                    d = np.hypot(nx - x, ny - y)
                    if best_d is None or d < best_d:
                        best, best_d = (nx, ny), d
        if best is not None:
            kept.append(best)
        # else: dropped altogether (client "skipped_n")

    kept = np.asarray(kept if kept else [np.asarray(wps)[0]], np.float32)
    n = min(len(kept), int(wps.shape[0]))
    out = np.zeros_like(np.asarray(wps, np.float32))
    out[:n] = kept[:n]
    out[n:] = kept[n - 1]
    return out, n


def init_dispatch(wps, n_wps, cfg: PlannerConfig) -> DispatchState:
    """wps (B, max_waypoints, 2) float32, n_wps (B,) int tensors."""
    B = wps.shape[0]
    dev = wps.device
    zi = torch.zeros(B, dtype=torch.int32, device=dev)
    zb = torch.zeros(B, dtype=torch.bool, device=dev)
    wps = wps.to(torch.float32)
    return DispatchState(
        wps=wps, wps_proj=wps.clone(), n_wps=n_wps.to(torch.int32),
        skip=torch.zeros(B, cfg.max_waypoints, dtype=torch.bool, device=dev),
        idx=zi, target=wps[:, 0].clone(), ticks_on_wp=zi.clone(),
        plan_fails=zi.clone(),
        path_xy=torch.zeros(B, cfg.path_len, 2, device=dev),
        n_path=zi.clone(), has_path=zb, plan_version=zi.clone(),
        plan_tick=zi - 10 ** 6,
        planned_target=torch.full((B, 2), 1e9, device=dev),
        reached_count=zi.clone(), skipped_count=zi.clone(),
        done=zb.clone(), goal_blocked=zb.clone(), blocked_ticks=zi.clone())


def _rows(x):
    return torch.arange(x.shape[0], device=x.device)


def _bcast(x, pts):
    """Per-route (B,) values broadcast against points pts (B, ..., 2)."""
    return x.reshape((x.shape[0],) + (1,) * (pts.dim() - 2))


def _cost_at(cost_win, win_r0, win_c0, xy, map_cfg: MapConfig, W: int):
    """Costmap cost at world points xy (B, ..., 2); 0 outside the window
    (unknown = free, like Nav2 beyond the rolling costmap)."""
    c = (xy[..., 0] - map_cfg.origin_x) / map_cfg.resolution - \
        _bcast(win_c0, xy)
    r = (xy[..., 1] - map_cfg.origin_y) / map_cfg.resolution - \
        _bcast(win_r0, xy)
    ri = r.clamp(0, W - 1).to(torch.int64)
    ci = c.clamp(0, W - 1).to(torch.int64)
    inside = (r >= 0) & (r < W) & (c >= 0) & (c < W)
    b = _rows(xy).reshape((xy.shape[0],) + (1,) * (xy.dim() - 2))
    vals = cost_win[b, ri, ci]
    return torch.where(inside, vals, torch.zeros_like(vals))


def _cost_peak_3x3(cost_win, win_r0, win_c0, xy, map_cfg: MapConfig, W: int):
    """Max cost in the 3x3 neighbourhood of xy (B, 2)."""
    offs = torch.tensor([[dr, dc] for dr in (-1, 0, 1) for dc in (-1, 0, 1)],
                        dtype=torch.float32, device=xy.device) \
        * map_cfg.resolution
    pts = xy[:, None, :] + offs[None, :, [1, 0]]
    return _cost_at(cost_win, win_r0, win_c0, pts, map_cfg, W).amax(1)


def project_waypoints(state: DispatchState, cost_win, win_r0, win_c0,
                      map_cfg: MapConfig, cfg: PlannerConfig) -> DispatchState:
    """Re-project every future WP to the nearest free cell (brute-force
    nearest low-cost cell within the window), with the v56-B rule: a free
    cell farther than proj_max_shift keeps the original WP; none within
    proj_max_search marks the WP skipped."""
    W = cfg.window
    res = map_cfg.resolution
    B, NW = state.skip.shape
    dev = cost_win.device

    ar = torch.arange(W, device=dev)
    cell_x = map_cfg.origin_x + (ar[None, None, :] + win_c0[:, None, None]
                                 + 0.5) * res                  # (B, 1, W)
    cell_y = map_cfg.origin_y + (ar[None, :, None] + win_r0[:, None, None]
                                 + 0.5) * res                  # (B, W, 1)
    free = cost_win < cfg.proj_cost_thresh

    half = W / 2 * res
    win_cx = map_cfg.origin_x + (win_c0 + W / 2) * res
    win_cy = map_cfg.origin_y + (win_r0 + W / 2) * res

    wp = state.wps                                             # (B, NW, 2)
    d2 = (cell_x[:, None] - wp[..., 0, None, None]) ** 2 + \
        (cell_y[:, None] - wp[..., 1, None, None]) ** 2       # (B, NW, W, W)
    own_cost = _cost_at(cost_win, win_r0, win_c0, wp, map_cfg, W)
    inside = ((wp[..., 0] - win_cx[:, None]).abs() < half) & \
        ((wp[..., 1] - win_cy[:, None]).abs() < half)
    ar_w = torch.arange(NW, device=dev)[None, :]
    active = (ar_w >= state.idx[:, None]) & (ar_w < state.n_wps[:, None])
    needs = inside & active & (own_cost >= cfg.proj_cost_thresh)

    d2_free = torch.where(free[:, None], d2, torch.full_like(d2, float("inf")))
    flat = d2_free.reshape(B, NW, W * W)
    k = flat.argmin(-1)                                        # (B, NW)
    best_d = torch.sqrt(torch.gather(flat, 2, k[..., None])[..., 0])
    br, bc = k // W, k % W
    bx = map_cfg.origin_x + (bc + win_c0[:, None] + 0.5) * res
    by = map_cfg.origin_y + (br + win_r0[:, None] + 0.5) * res

    found = best_d <= cfg.proj_max_search_m
    keep_orig = best_d > cfg.proj_max_shift_m  # v56-B: keep original
    moved = needs & found & ~keep_orig
    new_wp = torch.where(moved[..., None],
                         torch.stack([bx, by], -1).to(torch.float32), wp)
    new_skip = torch.where(needs, ~found, state.skip & active)
    return state._replace(wps_proj=new_wp, skip=new_skip)


def find_detour(cost_win, win_r0, win_c0, wp, map_cfg: MapConfig,
                cfg: PlannerConfig):
    """Detour ring: detour_samples per radius, accept cost <
    detour_max_cost, lowest cost wins with smaller radii preferred."""
    dev = wp.device
    n = cfg.detour_samples
    angles = 2.0 * math.pi * torch.arange(n, device=dev, dtype=torch.float32) / n
    radii = torch.tensor(cfg.detour_radii, dtype=torch.float32, device=dev)
    dx = radii[:, None] * torch.cos(angles)[None, :]
    dy = radii[:, None] * torch.sin(angles)[None, :]
    cand = wp[:, None, None, :] + torch.stack([dx, dy], -1)[None]  # (B, R, S, 2)
    costs = _cost_at(cost_win, win_r0, win_c0, cand, map_cfg, cfg.window)
    ring_pen = torch.arange(len(cfg.detour_radii), dtype=torch.float32,
                            device=dev)[:, None] * 1000.0
    score = torch.where(costs < cfg.detour_max_cost, costs + ring_pen,
                        torch.full_like(costs, float("inf")))
    flat = score.reshape(score.shape[0], -1)
    k = flat.argmin(1)
    rows = _rows(wp)
    ok = torch.isfinite(flat[rows, k])
    best = cand.reshape(cand.shape[0], -1, 2)[rows, k]
    return best, ok


def too_close_to_known(xy, known_xy, known_r, known_active,
                       clearance: float = 0.9):
    """send_goals _wp_too_close_to_known: clearance check of xy (B, 2)
    against a-priori known dropped obstacles (B, N)."""
    d = torch.sqrt(((xy[:, None, :] - known_xy) ** 2).sum(-1))
    return (known_active & (d < known_r + clearance)).any(-1)


def dispatch_plan(state: DispatchState, robot_xy, cost_win, win_r0, win_c0,
                  known_xy, known_r, known_active,
                  map_cfg: MapConfig, cfg: PlannerConfig,
                  tick=0, coarse_phi=None, coarse_goal=None) -> DispatchState:
    """Heavy phase (costmap cadence): reproject WPs, pick the target (WP or
    detour), run the wavefront planner.  A good new plan replaces the
    committed path only when the target changed, the committed path is
    older than ``replan_period``, or there is no path yet.  Under
    ``stock_follow`` a lethal believed start or an all-lethal goal disc
    fails the plan (``goal_blocked``) and clears ``has_path``."""
    if cfg.enable_projection:
        state = project_waypoints(state, cost_win, win_r0, win_c0, map_cfg,
                                  cfg)
    rows = _rows(robot_xy)
    idx = torch.minimum(state.idx, state.n_wps - 1).long()
    is_final = idx >= state.n_wps - cfg.final_wp_count
    wp = state.wps_proj[rows, idx]

    if cfg.enable_known_obstacle_gate:
        known_hit = too_close_to_known(wp, known_xy, known_r, known_active)
    else:
        known_hit = torch.zeros_like(is_final)
    if cfg.enable_lookahead_skip:
        wp_cost = _cost_peak_3x3(cost_win, win_r0, win_c0, wp, map_cfg,
                                 cfg.window)
        unsafe = (~is_final) & (known_hit |
                                (wp_cost >= cfg.lookahead_skip_cost))
    else:
        unsafe = known_hit & ~is_final

    detour_xy, detour_ok = find_detour(cost_win, win_r0, win_c0, wp,
                                       map_cfg, cfg)
    detour_ok = detour_ok & ~too_close_to_known(
        detour_xy, known_xy, known_r, known_active) & cfg.enable_detour
    target = torch.where((unsafe & detour_ok)[:, None], detour_xy, wp)
    # unsafe with no detour -> mark skip (consumed by dispatch_move)
    skip = state.skip.clone()
    skip[rows, idx] = skip[rows, idx] | (unsafe & ~detour_ok)

    # two-level escape hatch: the coarse potential seeds the window border
    # only after sustained window-plan failure
    if coarse_phi is not None:
        escape = state.plan_fails >= cfg.coarse_escape_fails
        coarse_goal = torch.where(escape[:, None], coarse_goal,
                                  torch.full_like(coarse_goal, 1e9))
    plan = plan_world(cost_win, win_r0, win_c0, robot_xy, target, map_cfg,
                      cfg, coarse_phi=coarse_phi, coarse_goal=coarse_goal)
    plan_good = plan.ok & (plan.n_path > 1)

    if cfg.stock_follow:
        # NavFn clears the start cell, but for the stock baseline a believed
        # pose inside mapped inflation stands in for the reference's
        # physical wedge-stall: the BT loops recoveries in place; and NavFn
        # fails when every cell within the goal tolerance (8 directions x
        # 3 radii) is lethal
        start_lethal = _cost_at(cost_win, win_r0, win_c0, robot_xy, map_cfg,
                                cfg.window) >= 99.0
        plan_good = plan_good & ~start_lethal
        tol = cfg.stock_goal_tolerance_m
        ang = 2.0 * math.pi * torch.arange(8, dtype=torch.float32,
                                           device=target.device) / 8
        rads = torch.tensor([0.0, 0.5 * tol, tol], dtype=torch.float32,
                            device=target.device)
        ring = torch.stack([torch.cos(ang), torch.sin(ang)], -1)
        disc = target[:, None, None, :] + \
            rads[None, :, None, None] * ring[None, None]       # (B, 3, 8, 2)
        disc_cost = _cost_at(cost_win, win_r0, win_c0, disc, map_cfg,
                             cfg.window)
        goal_blocked = (disc_cost.flatten(1).amin(1) >= 99.0) | start_lethal
    else:
        goal_cost = _cost_peak_3x3(cost_win, win_r0, win_c0, target, map_cfg,
                                   cfg.window)
        goal_blocked = goal_cost >= 99.0

    dt = target - state.planned_target
    target_changed = torch.sqrt((dt * dt).sum(-1)) > 0.5
    stale = (tick - state.plan_tick) >= cfg.replan_period
    accept = plan_good & (target_changed | stale | (~state.has_path))
    has_path = accept | state.has_path
    if cfg.stock_follow:
        # a planner-failed goal leaves the BT with no path: the controller
        # publishes zero and the progress checker cycles the recoveries
        accept = accept & ~goal_blocked
        has_path = has_path & ~goal_blocked

    one = torch.ones_like(state.plan_version)
    zero = torch.zeros_like(state.plan_version)
    return state._replace(
        target=target,
        skip=skip,
        path_xy=torch.where(accept[:, None, None], plan.path_xy,
                            state.path_xy),
        n_path=torch.where(accept, plan.n_path, state.n_path),
        has_path=has_path,
        plan_version=state.plan_version + torch.where(accept, one, zero),
        plan_tick=torch.where(accept, zero + tick, state.plan_tick),
        planned_target=torch.where(accept[:, None], target,
                                   state.planned_target),
        plan_fails=torch.where(plan_good, zero, state.plan_fails + 1),
        goal_blocked=goal_blocked,
    )


def dispatch_move(state: DispatchState, robot_xy, known_xy, known_r,
                  known_active, cfg: PlannerConfig) -> DispatchState:
    """Cheap phase — every tick: reach / skip / timeout / advance."""
    rows = _rows(robot_xy)
    idx = torch.minimum(state.idx, state.n_wps - 1).long()
    is_final = idx >= state.n_wps - cfg.final_wp_count

    d = torch.sqrt(((state.target - robot_xy) ** 2).sum(-1))
    reached = d < cfg.tolerance_m

    # v59 late-detect: abandon a target on a known obstacle once close
    if cfg.enable_known_obstacle_gate:
        late_detect = (~is_final) & (d < 3.0) & too_close_to_known(
            state.target, known_xy, known_r, known_active)
    else:
        late_detect = torch.zeros_like(is_final)

    if cfg.stock_follow:
        # stock WaypointFollower: no per-WP timeout.  A planner-failed goal
        # leaves the BT path-less until NavigateToPose aborts after
        # stock_abort_ticks; stop_on_failure=false then moves on
        skip_now = state.skip[rows, idx]
        aborted = state.goal_blocked & \
            (state.blocked_ticks >= cfg.stock_abort_ticks)
        fail_skip = aborted | (~state.goal_blocked &
                               (state.plan_fails >= cfg.max_plan_fails))
    else:
        skip_now = (state.skip[rows, idx] | late_detect) & ~is_final
        max_fails = torch.where(is_final,
                                torch.full_like(state.plan_fails, 10 ** 6),
                                torch.full_like(state.plan_fails,
                                                cfg.max_plan_fails))
        timeout = torch.where(is_final,
                              torch.full_like(state.plan_fails,
                                              2 * cfg.goal_timeout_ticks),
                              torch.full_like(state.plan_fails,
                                              cfg.goal_timeout_ticks))
        fail_skip = (state.plan_fails >= max_fails) | \
            (state.ticks_on_wp >= timeout)

    advance = (reached | skip_now | fail_skip) & ~state.done
    one = torch.ones_like(state.idx)
    zero = torch.zeros_like(state.idx)
    new_idx = torch.minimum(state.idx + torch.where(advance, one, zero),
                            state.n_wps)
    done = state.done | (new_idx >= state.n_wps)

    # on advance, aim at the next projected WP until the next plan phase
    next_wp = state.wps_proj[rows, torch.minimum(new_idx,
                                                 state.n_wps - 1).long()]
    return state._replace(
        idx=new_idx,
        target=torch.where(advance[:, None], next_wp, state.target),
        ticks_on_wp=torch.where(advance, zero, state.ticks_on_wp + 1),
        plan_fails=torch.where(advance, zero, state.plan_fails),
        blocked_ticks=torch.where(advance | ~state.goal_blocked, zero,
                                  state.blocked_ticks + 1),
        reached_count=state.reached_count
        + torch.where(reached & advance, one, zero),
        skipped_count=state.skipped_count
        + torch.where((skip_now | fail_skip) & ~reached & advance, one, zero),
        done=done,
    )
