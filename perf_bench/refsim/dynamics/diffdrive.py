"""Batched differential-drive UGV dynamics on the analytic terrain
(``nclt_slam_tpu/dynamics/diffdrive.py``).

A diff-drive unicycle with first-order wheel-drive lag, multiplicative wheel
slip noise and terrain-conforming attitude, stepped at 200 Hz with the
reference's 20:1 sensor decimation.  Every tensor carries a leading route
dimension B.  Collision is kinematic: motion into an inflated collider disc
is cancelled (the robot "wedges").
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from refsim.config import SimConfig
from refsim.core import prng
from refsim.core.quat import quat_from_yaw, quat_mul
from refsim.scene.terrain import terrain_height, terrain_pitch_roll

ROBOT_RADIUS = 0.4        # Husky half-footprint (generate_routes.py ROBOT_R)
CHASSIS_CLEARANCE = 0.13  # base_link height above contact


class RobotState(NamedTuple):
    xy: torch.Tensor        # (B, 2) world position
    yaw: torch.Tensor       # (B,) heading
    v: torch.Tensor         # (B,) actual forward speed (after drive lag)
    w: torch.Tensor         # (B,) actual yaw rate
    wedged: torch.Tensor    # (B,) bool — last substep was blocked


def init_robot(spawn, spawn_yaw) -> RobotState:
    """spawn (B, 2), spawn_yaw (B,) float32 tensors."""
    z = torch.zeros_like(spawn_yaw)
    return RobotState(xy=spawn.clone(), yaw=spawn_yaw.clone(), v=z, w=z.clone(),
                      wedged=torch.zeros_like(spawn_yaw, dtype=torch.bool))


def _collider_block(xy_new, xy_old, obs_xy, obs_r, obs_valid):
    """Cancel motion that would penetrate a collider disc."""
    dx = xy_new[:, None, 0] - obs_xy[..., 0]
    dy = xy_new[:, None, 1] - obs_xy[..., 1]
    d = torch.sqrt(dx * dx + dy * dy)
    blocked = ((d < obs_r + ROBOT_RADIUS) & obs_valid).any(-1)
    return torch.where(blocked[:, None], xy_old, xy_new), blocked


@functools.lru_cache(maxsize=8)
def _drive_gains(cfg: SimConfig):
    """(dt, (a_v, a_w)): the per-substep lag gains 1 - exp(-dt / tau),
    evaluated in float32 like the JAX package."""
    dt = 1.0 / cfg.physics_hz
    a = torch.exp(torch.tensor([-dt / cfg.v_tau, -dt / cfg.w_tau],
                               dtype=torch.float32))
    return dt, (1.0 - a).tolist()


def substep(state: RobotState, cmd_v, cmd_w, obs_xy, obs_r, obs_valid,
            noise, cfg: SimConfig) -> RobotState:
    """One 200 Hz physics step.  ``noise`` (B, 2) holds the two standard
    normals the JAX package draws from this substep's key (slip on v, w)."""
    dt, (a_v, a_w) = _drive_gains(cfg)
    half_track = 0.5 * cfg.track_width
    vl = (cmd_v - cmd_w * half_track) / cfg.wheel_radius
    vr = (cmd_v + cmd_w * half_track) / cfg.wheel_radius
    vl = vl.clamp(-cfg.max_wheel_speed, cfg.max_wheel_speed)
    vr = vr.clamp(-cfg.max_wheel_speed, cfg.max_wheel_speed)
    v_tgt = 0.5 * (vl + vr) * cfg.wheel_radius
    w_tgt = (vr - vl) * cfg.wheel_radius / cfg.track_width

    # first-order drive lag (PhysX DriveAPI behaves like a velocity servo)
    v = state.v + a_v * (v_tgt - state.v)
    w = state.w + a_w * (w_tgt - state.w)
    # wheel-terrain slip noise (multiplicative, zero-mean)
    v = v * (1.0 + cfg.slip_std * noise[:, 0])
    w = w * (1.0 + cfg.slip_std * noise[:, 1])

    yaw = state.yaw + w * dt
    step = torch.stack([torch.cos(yaw), torch.sin(yaw)], -1) * (v * dt)[:, None]
    xy_new, blocked = _collider_block(state.xy + step, state.xy,
                                      obs_xy, obs_r, obs_valid)
    v = torch.where(blocked, torch.zeros_like(v), v)
    return RobotState(xy=xy_new, yaw=torch.atan2(torch.sin(yaw), torch.cos(yaw)),
                      v=v, w=w, wedged=blocked)


def robot_pose3d(state: RobotState):
    """Full 3D pose implied by the terrain: (pos (B, 3), quat xyzw (B, 4)).
    The base settles on the heightfield; pitch/roll follow the local slope."""
    return _pose3d(state.xy, state.yaw)


def _pose3d(xy, yaw):
    """``robot_pose3d`` elementwise over any batch shape."""
    x, y = xy[..., 0], xy[..., 1]
    z = terrain_height(x, y) + CHASSIS_CLEARANCE
    pitch, roll = terrain_pitch_roll(x, y, yaw)
    zero = torch.zeros_like(pitch)
    q_yaw = quat_from_yaw(yaw)
    q_pitch = torch.stack([zero, torch.sin(pitch / 2), zero,
                           torch.cos(pitch / 2)], -1)
    q_roll = torch.stack([torch.sin(roll / 2), zero, zero,
                          torch.cos(roll / 2)], -1)
    q = quat_mul(q_yaw, quat_mul(q_pitch, q_roll))
    return torch.stack([x, y, z], -1), q


def slip_noise(key, n_substeps: int):
    """The (B, n_substeps, 2) slip normals ``nav_substeps`` draws: the JAX
    package splits the tick key into one key per substep and each of those
    into a (v, w) pair, then draws one normal from each — all 2n derived
    and drawn here in one vectorised pass."""
    sub = prng.split(prng.split(key, n_substeps), 2)   # (B, n, 2, 2)
    return prng.normal(sub)


def nav_substeps(state: RobotState, cmd_v, cmd_w, obs_xy, obs_r, obs_valid,
                 key, cfg: SimConfig):
    """Run one nav tick = ``cfg.nav_decimation`` physics substeps.

    Returns (new_state, (pos (B, n, 3), quat (B, n, 4))) — the per-substep
    3D pose the 200 Hz IMU model consumes, computed after the loop in one
    elementwise pass over all substeps."""
    noise = slip_noise(key, cfg.nav_decimation)
    xys, yaws = [], []
    for i in range(cfg.nav_decimation):
        state = substep(state, cmd_v, cmd_w, obs_xy, obs_r, obs_valid,
                        noise[:, i], cfg)
        xys.append(state.xy)
        yaws.append(state.yaw)
    return state, _pose3d(torch.stack(xys, 1), torch.stack(yaws, 1))
