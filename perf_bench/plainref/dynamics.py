"""The wheel dynamics of one navigation tick, in float64 NumPy.

A differential-drive robot stepped ``n`` times at ``physics_hz``: the
commanded (v, w) become wheel speeds clamped to ``max_wheel_speed``, the
body speeds follow them through a first-order lag (gain 1 - exp(-dt /
tau)), each is scaled by (1 + slip_std n) with n a standard normal of the
substep's key, the heading advances by w dt, the position by v dt along
the new heading, and a step that would bring the robot's centre within
``obs_r + 0.4`` m of a valid collider is undone (the robot wedges; its
speed drops to 0).  The heading is returned wrapped to (-pi, pi].
"""

from __future__ import annotations

import numpy as np

from plainref import threefry

ROBOT_RADIUS = 0.4      # the Husky's half footprint


def nav_substeps(xy, yaw, v, w, cmd_v, cmd_w, obs_xy, obs_r, obs_valid, key,
                 sim) -> dict:
    """Arrays (B, ...) in, float64 dict out: the final ``xy``, ``yaw``,
    ``v``, ``w``, ``wedged`` and each substep's position ``path_xy``
    (B, n, 2)."""
    n = int(sim.nav_decimation)
    dt = 1.0 / sim.physics_hz
    g_v = 1.0 - np.exp(-dt / sim.v_tau)
    g_w = 1.0 - np.exp(-dt / sim.w_tau)
    sub = threefry.split(threefry.split(key, n), 2)      # (B, n, 2, 2)
    slip = threefry.normal(sub, 1)[..., 0]               # (B, n, 2)
    f = lambda a: np.asarray(a, np.float64)             # noqa: E731
    xy, yaw, v, w = f(xy).copy(), f(yaw).copy(), f(v).copy(), f(w).copy()
    cmd_v, cmd_w, obs_xy, obs_r = f(cmd_v), f(cmd_w), f(obs_xy), f(obs_r)
    obs_valid = np.asarray(obs_valid, bool)
    r, track = sim.wheel_radius, sim.track_width
    wedged = np.zeros(xy.shape[0], bool)
    path = []
    for i in range(n):
        left = np.clip((cmd_v - cmd_w * track / 2) / r, -sim.max_wheel_speed,
                       sim.max_wheel_speed)
        right = np.clip((cmd_v + cmd_w * track / 2) / r,
                        -sim.max_wheel_speed, sim.max_wheel_speed)
        v = v + g_v * ((left + right) * r / 2 - v)
        w = w + g_w * ((right - left) * r / track - w)
        v = v * (1.0 + sim.slip_std * slip[:, i, 0])
        w = w * (1.0 + sim.slip_std * slip[:, i, 1])
        heading = yaw + w * dt
        new = xy + np.stack([np.cos(heading), np.sin(heading)], -1) * \
            (v * dt)[:, None]
        dist = np.linalg.norm(new[:, None, :] - obs_xy, axis=-1)
        wedged = ((dist < obs_r + ROBOT_RADIUS) & obs_valid).any(-1)
        xy = np.where(wedged[:, None], xy, new)
        v = np.where(wedged, 0.0, v)
        yaw = np.arctan2(np.sin(heading), np.cos(heading))
        path.append(xy)
    return {"xy": xy, "yaw": yaw, "v": v, "w": w, "wedged": wedged,
            "path_xy": np.stack(path, 1)}
