"""Stock Nav2 controller stack: RegulatedPurePursuit + BT recovery behaviours
(``nclt_slam_tpu/control/rpp.py``).

The stock baseline drives with the full stock Nav2 stack: the
RegulatedPurePursuitController (velocity-scaled lookahead, curvature
regulation, approach scaling, forward-only, no rotate-to-heading), a
SimpleProgressChecker (0.3 m / 30 s), and the recovery suite the behaviour
tree cycles through when progress stalls (spin -> backup -> wait).  None of
the thesis follower's additions exist here: no proximity limiter, no
anti-spin monitor, no wedge reversal.

Batched over routes (leading dimension); every branch is a ``torch.where``
mask.  Ties in the closest-point ``argmin`` and the first-far ``argmax``
keep the lowest index, as XLA's do.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from refsim.config import RppConfig

# recovery phases (BT round-robin: spin, backup, wait — behavior_server)
PHASE_NONE = 0
PHASE_SPIN = 1
PHASE_BACKUP = 2
PHASE_WAIT = 3


class RppState(NamedTuple):
    prev_v: torch.Tensor          # (B,) float32 — velocity-scaled lookahead input
    anchor_xy: torch.Tensor       # (B, 2) progress-checker anchor
    anchor_t: torch.Tensor        # (B,) float32
    anchor_set: torch.Tensor      # (B,) bool
    phase: torch.Tensor           # (B,) int32 recovery phase
    phase_until: torch.Tensor     # (B,) float32
    recovery_count: torch.Tensor  # (B,) int32 — total recoveries triggered


def init_rpp(batch: int, device) -> RppState:
    z = torch.zeros(batch, dtype=torch.float32, device=device)
    zi = torch.zeros(batch, dtype=torch.int32, device=device)
    return RppState(
        prev_v=z, anchor_xy=torch.zeros(batch, 2, device=device),
        anchor_t=z.clone(),
        anchor_set=torch.zeros(batch, dtype=torch.bool, device=device),
        phase=zi + PHASE_NONE, phase_until=z.clone(), recovery_count=zi.clone())


def _norm(x):
    return torch.sqrt((x * x).sum(-1))


def rpp_tick(state: RppState, pos, yaw, path_xy, n_path, path_active,
             t_now, cfg: RppConfig):
    """One 10 Hz stock-controller tick for the route batch: pos (B, 2), yaw
    (B,), path_xy (B, P, 2), n_path (B,), path_active (B,) bool, t_now a
    float32 scalar tensor.  Returns (new_state, v, w)."""
    B, P = path_xy.shape[:2]
    rows = torch.arange(B, device=pos.device)
    idxs = torch.arange(P, device=pos.device)[None, :]
    d = _norm(path_xy - pos[:, None, :])                       # (B, P)
    on_path = idxs < n_path[:, None]

    # --- carrot: velocity-scaled lookahead (use_velocity_scaled_lookahead);
    # RPP walks forward from the closest path point to the first point >= L
    L = (state.prev_v * cfg.lookahead_time).clamp(cfg.min_lookahead,
                                                  cfg.max_lookahead)
    closest = torch.where(on_path, d, torch.full_like(d, float("inf"))) \
        .argmin(1)
    far = on_path & (idxs >= closest[:, None]) & (d >= L[:, None])
    any_far = far.any(1)
    last = (n_path - 1).clamp_min(0).long()
    tgt_idx = torch.where(any_far, far.to(torch.uint8).argmax(1), last)
    carrot = path_xy[rows, tgt_idx]

    # --- pure-pursuit arc ---
    alpha = torch.atan2(carrot[:, 1] - pos[:, 1],
                        carrot[:, 0] - pos[:, 0]) - yaw
    alpha = torch.atan2(torch.sin(alpha), torch.cos(alpha))
    L_eff = _norm(carrot - pos).clamp_min(0.1)
    kappa = 2.0 * torch.sin(alpha) / L_eff

    zero = torch.zeros_like(kappa)
    v = zero + cfg.desired_linear_vel

    # regulated curvature scaling (use_regulated_linear_velocity_scaling)
    radius = 1.0 / kappa.abs().clamp_min(1e-6)
    v_reg = torch.clamp_min(v * radius / cfg.regulated_min_radius,
                            cfg.regulated_min_speed)
    v = torch.where(radius < cfg.regulated_min_radius, v_reg, v)

    # approach velocity scaling near the path end
    d_end = _norm(path_xy[rows, last] - pos)
    v_app = torch.clamp_min(v * d_end / cfg.approach_scaling_dist,
                            cfg.min_approach_vel)
    v = torch.where(d_end < cfg.approach_scaling_dist, torch.minimum(v, v_app),
                    v)

    # forward-only (allow_reversing: false, use_rotate_to_heading: false)
    v = v.clamp_min(0.0)
    w = (v * kappa).clamp(-cfg.max_angular_vel, cfg.max_angular_vel)

    # --- SimpleProgressChecker: movement anchor ---
    moved = _norm(pos - state.anchor_xy) > cfg.required_movement_radius
    reset_anchor = moved | ~state.anchor_set
    anchor_xy = torch.where(reset_anchor[:, None], pos, state.anchor_xy)
    anchor_t = torch.where(reset_anchor, t_now, state.anchor_t)
    stalled = state.anchor_set & ~moved & \
        (t_now - anchor_t > cfg.movement_time_allowance) & path_active

    # --- recovery state machine (BT: spin -> backup -> wait, cycling) ---
    in_recovery = state.phase != PHASE_NONE
    phase_over = in_recovery & (t_now >= state.phase_until)

    # enter recovery on stall (round-robin start phase, like the BT's
    # RoundRobin recovery node)
    start_phase = torch.remainder(state.recovery_count, 3) + 1
    enter = stalled & ~in_recovery
    phase = torch.where(enter, start_phase, state.phase)
    dur = torch.where(phase == PHASE_SPIN, zero + cfg.spin_duration_s,
                      torch.where(phase == PHASE_BACKUP,
                                  zero + cfg.backup_duration_s,
                                  zero + cfg.wait_duration_s))
    phase_until = torch.where(enter, t_now + dur, state.phase_until)
    # phase expiry -> hand control back to the controller (PHASE_NONE) and
    # reset the progress anchor so the checker gets a fresh allowance
    phase = torch.where(phase_over, torch.zeros_like(phase), phase)
    renew = phase_over | enter
    anchor_xy = torch.where(renew[:, None], pos, anchor_xy)
    anchor_t = torch.where(renew, t_now, anchor_t)

    rec_v = torch.where(phase == PHASE_BACKUP, zero + cfg.backup_vel, zero)
    rec_w = torch.where(phase == PHASE_SPIN, zero + cfg.spin_vel, zero)
    active_recovery = phase != PHASE_NONE
    v = torch.where(active_recovery, rec_v, v)
    w = torch.where(active_recovery, rec_w, w)

    # no path -> controller_server publishes zero Twist
    moving = path_active | active_recovery
    v = torch.where(moving, v, zero)
    w = torch.where(moving, w, zero)

    new_state = RppState(
        prev_v=v, anchor_xy=anchor_xy, anchor_t=anchor_t,
        anchor_set=torch.ones_like(state.anchor_set), phase=phase,
        phase_until=phase_until,
        recovery_count=state.recovery_count + enter.to(torch.int32))
    return new_state, v, w
