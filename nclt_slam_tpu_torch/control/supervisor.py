"""Turnaround supervisor (``nclt_slam_tpu/control/supervisor.py``).

Watches the GT pose; once the robot has been > 30 m from the final
(turnaround) point and then comes back within the near radius, it FIREs
once — the fire flag masks the drop colliders out of the scene.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nclt_slam_tpu_torch.config import SupervisorConfig


class SupervisorState(NamedTuple):
    been_far: torch.Tensor   # (B,) bool
    fired: torch.Tensor      # (B,) bool


def init_supervisor(batch: int, device) -> SupervisorState:
    f = torch.zeros(batch, dtype=torch.bool, device=device)
    return SupervisorState(been_far=f, fired=f.clone())


def supervisor_tick(state: SupervisorState, gt_xy, final_xy,
                    cfg: SupervisorConfig) -> SupervisorState:
    d = torch.sqrt(((gt_xy - final_xy) ** 2).sum(-1))
    been_far = state.been_far | (d > cfg.far_dist)
    fire = state.fired | (been_far & (d < cfg.near_radius))
    return SupervisorState(been_far=been_far, fired=fire)
