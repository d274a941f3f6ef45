"""Pure-pursuit path follower with the reference's recovery stack
(``nclt_slam_tpu/control/pure_pursuit.py``).

2.0 m lookahead target on the current plan, v = 0.8·max(0.3, 1−|err|/1.57),
w = clamp(1.2·err, ±0.8); the proximity limiter (3×3 ego-tube samples; cost
≥ 50 → 0.4 m/s, ≥ 99 → 0.15); the anti-spin monitor; and the wedge recovery.
All branches are ``torch.where`` masks over the leading route dimension.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nclt_slam_tpu_torch.config import ControlConfig, MapConfig

HIST = 64  # pos-history ring (6.4 s at 10 Hz; covers both 4 s and 5 s windows)


class CtrlState(NamedTuple):
    pos_hist: torch.Tensor        # (B, HIST, 2)
    hist_n: torch.Tensor          # (B,) int32
    path_idx: torch.Tensor        # (B,) int32 — monotonic progress
    path_version: torch.Tensor    # (B,) int32 — plan id of the progress
    spin_accum: torch.Tensor      # (B,) float32 seconds
    cooldown_until: torch.Tensor  # (B,) float32 sim-time
    wedge_until: torch.Tensor     # (B,) float32 sim-time
    prox_activations: torch.Tensor
    spin_activations: torch.Tensor
    wedge_activations: torch.Tensor


def init_ctrl(batch: int, device) -> CtrlState:
    z = torch.zeros(batch, dtype=torch.float32, device=device)
    zi = torch.zeros(batch, dtype=torch.int32, device=device)
    return CtrlState(
        pos_hist=torch.zeros(batch, HIST, 2, device=device),
        hist_n=zi, path_idx=zi.clone(), path_version=zi - 1,
        spin_accum=z, cooldown_until=z.clone(), wedge_until=z.clone(),
        prox_activations=zi.clone(), spin_activations=zi.clone(),
        wedge_activations=zi.clone())


def _rows(x):
    return torch.arange(x.shape[0], device=x.device)


def _disp_over(state: CtrlState, pos, window_ticks: int):
    """Displacement between now and ``window_ticks`` ago (ring lookup)."""
    past_slot = torch.remainder(state.hist_n - window_ticks, HIST).long()
    past = state.pos_hist[_rows(pos), past_slot]
    have = state.hist_n >= window_ticks
    d = torch.sqrt(((pos - past) ** 2).sum(-1))
    return torch.where(have, d, torch.full_like(d, float("inf")))


def _prox_cost(cost_win, win_r0, win_c0, pos, yaw, map_cfg: MapConfig,
               cfg: ControlConfig, window: int):
    """Max cost over the forward ego-tube samples."""
    c, s = torch.cos(yaw)[:, None, None], torch.sin(yaw)[:, None, None]
    d = torch.tensor(cfg.prox_sample_dist, dtype=torch.float32,
                     device=pos.device)[None, :, None]
    lat = torch.tensor(cfg.prox_sample_lat, dtype=torch.float32,
                       device=pos.device)[None, None, :]
    px = pos[:, 0, None, None] + d * c - lat * s
    py = pos[:, 1, None, None] + d * s + lat * c
    cc = (px - map_cfg.origin_x) / map_cfg.resolution - win_c0[:, None, None]
    rr = (py - map_cfg.origin_y) / map_cfg.resolution - win_r0[:, None, None]
    ri = rr.clamp(0, window - 1).to(torch.int64)
    ci = cc.clamp(0, window - 1).to(torch.int64)
    inside = (rr >= 0) & (rr < window) & (cc >= 0) & (cc < window)
    vals = cost_win[_rows(pos)[:, None, None], ri, ci]
    return torch.where(inside, vals, torch.zeros_like(vals)).amax((1, 2))


def follower_tick(state: CtrlState, pos, yaw, path_xy, n_path, path_active,
                  plan_version, cost_win, win_r0, win_c0, t_now,
                  map_cfg: MapConfig, cfg: ControlConfig, window: int):
    """One 10 Hz follower tick.  Returns (new_state, cmd_v, cmd_w)."""
    P = path_xy.shape[1]
    dt = 0.1
    rows = _rows(pos)

    # --- monotonic path progress (reset on a new plan) ---
    path_idx = torch.where(plan_version != state.path_version,
                           torch.zeros_like(state.path_idx), state.path_idx)
    d = torch.sqrt(((path_xy - pos[:, None, :]) ** 2).sum(-1))   # (B, P)
    idxs = torch.arange(P, device=pos.device)[None, :]
    ahead = (idxs >= path_idx[:, None]) & (idxs < n_path[:, None])
    closest = torch.where(ahead, d, torch.full_like(d, float("inf"))).argmin(1)
    path_idx = torch.maximum(path_idx, closest.to(torch.int32))

    # --- lookahead target: first point past path_idx >= LOOKAHEAD away ---
    eligible = (idxs >= path_idx[:, None]) & (idxs < n_path[:, None])
    far = eligible & (d >= cfg.lookahead)
    any_far = far.any(1)
    first_far = far.to(torch.uint8).argmax(1)
    last_valid = (n_path - 1).clamp_min(0).long()
    tgt_idx = torch.where(any_far, first_far, last_valid)
    tgt = path_xy[rows, tgt_idx]

    err = torch.atan2(tgt[:, 1] - pos[:, 1], tgt[:, 0] - pos[:, 0]) - yaw
    err = torch.atan2(torch.sin(err), torch.cos(err))

    v = cfg.max_vel * torch.clamp_min(1.0 - err.abs() / 1.57, 0.3)
    w = (cfg.gain_ang * err).clamp(-cfg.max_ang, cfg.max_ang)

    # --- proximity limiter ---
    prox = _prox_cost(cost_win, win_r0, win_c0, pos, yaw, map_cfg, cfg, window)
    v_cap = torch.where(prox >= cfg.prox_cost_lethal,
                        torch.full_like(prox, cfg.v_lethal),
                        torch.where(prox >= cfg.prox_cost_slow,
                                    torch.full_like(prox, cfg.v_slow),
                                    torch.full_like(prox, cfg.max_vel)))
    prox_hit = (v_cap < v) & cfg.enable_prox
    if cfg.enable_prox:
        v = torch.minimum(v, v_cap)

    # --- anti-spin accounting ---
    is_spinning = (w.abs() >= cfg.spin_w_thresh) & \
        (v.abs() <= cfg.spin_v_thresh * 2)
    spin_accum = torch.where(is_spinning, state.spin_accum + dt,
                             torch.clamp_min(state.spin_accum - 2 * dt, 0.0))

    # --- wedge recovery ---
    wedge_ticks = int(cfg.wedge_window_s / dt)
    wedge_disp = _disp_over(state, pos, wedge_ticks)
    in_wedge_backup = t_now < state.wedge_until
    trigger_wedge = (~in_wedge_backup) & \
        (wedge_disp < cfg.wedge_min_disp_m) & (v > 0.05) & \
        (state.hist_n > 30) & cfg.enable_wedge
    wedge_until = torch.where(trigger_wedge, t_now + cfg.wedge_backup_s,
                              state.wedge_until)
    backing = in_wedge_backup | trigger_wedge
    v = torch.where(backing, torch.full_like(v, cfg.wedge_backup_v), v)
    w = torch.where(backing, torch.zeros_like(w), w)

    # --- anti-spin cooldown (after wedge so wedge takes precedence) ---
    prog_ticks = int(cfg.progress_window_s / dt)
    progress = _disp_over(state, pos, prog_ticks)
    in_cooldown = t_now < state.cooldown_until
    trigger_spin = (~backing) & (~in_cooldown) & \
        (spin_accum >= cfg.spin_limit_s) & \
        (progress < cfg.min_progress_m) & cfg.enable_antispin
    cooldown_until = torch.where(trigger_spin, t_now + cfg.spin_cooldown_s,
                                 state.cooldown_until)
    crawling = (~backing) & (in_cooldown | trigger_spin)
    v = torch.where(crawling, torch.full_like(v, 0.15), v)
    w = torch.where(crawling, torch.zeros_like(w), w)
    spin_accum = torch.where(trigger_spin, torch.zeros_like(spin_accum),
                             spin_accum)

    # no path → stop (reference publishes zero Twist)
    v = torch.where(path_active, v, torch.zeros_like(v))
    w = torch.where(path_active, w, torch.zeros_like(w))

    # history ring update (reset on wedge trigger, like the reference)
    slot = torch.remainder(state.hist_n, HIST).long()
    pos_hist = state.pos_hist.clone()
    pos_hist[rows, slot] = pos
    hist_n = torch.where(trigger_wedge, torch.ones_like(state.hist_n),
                         state.hist_n + 1)
    reset = torch.zeros_like(pos_hist)
    reset[:, 0] = pos
    pos_hist = torch.where(trigger_wedge[:, None, None], reset, pos_hist)

    one = torch.ones_like(state.hist_n)
    zero = torch.zeros_like(state.hist_n)
    new_state = CtrlState(
        pos_hist=pos_hist,
        hist_n=hist_n,
        path_idx=path_idx,
        path_version=plan_version,
        spin_accum=spin_accum,
        cooldown_until=cooldown_until,
        wedge_until=wedge_until,
        prox_activations=state.prox_activations + torch.where(prox_hit, one, zero),
        spin_activations=state.spin_activations + torch.where(trigger_spin, one, zero),
        wedge_activations=state.wedge_activations + torch.where(trigger_wedge, one, zero),
    )
    return new_state, v, w
