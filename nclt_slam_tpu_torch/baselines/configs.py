"""Campaign baseline configs (``nclt_slam_tpu/baselines/configs.py``): config
points over the same rollout, repeated off the ours-stack teach artefacts.
"""

from __future__ import annotations

import dataclasses

from nclt_slam_tpu_torch import config as cfg_mod
from nclt_slam_tpu_torch.config import Config, LocalizationMode


def stock_nav2() -> Config:
    """exp 74: the stock Nav2 stack.

    - localization: VIO + encoder fusion WITHOUT visual anchors (stock Nav2
      had no matcher process feeding /anchor_correction)
    - controller: RegulatedPurePursuit + BT recovery behaviours
      (``control/rpp.py``) instead of the thesis follower; no proximity
      limiter / anti-spin / wedge recovery
    - dispatcher: FollowWaypoints semantics (``stock_follow``): one-time
      client-side WP projection, no live reprojection / detour ring /
      known-obstacle gate / lookahead skip, NO per-WP timeout, no final-WP
      policy; the baselines' GT-stall watchdog
    """
    base = cfg_mod.ours()
    return base.replace(
        mode=LocalizationMode(use_slam=True, use_anchors=False,
                              use_imu=True, use_gt=False),
        planner=dataclasses.replace(
            base.planner, enable_detour=False, enable_projection=False,
            enable_known_obstacle_gate=False, enable_lookahead_skip=False,
            stock_follow=True, gt_stall_abort=True),
        control=dataclasses.replace(
            base.control, enable_wedge=False, enable_antispin=False,
            enable_prox=False, use_rpp=True),
    )


def rgbd_no_imu() -> Config:
    """exp 76: our pipeline with pure RGB-D VIO (no inertial term); the
    anchor matcher stays on.  Baseline runs carry the GT-stall watchdog."""
    base = cfg_mod.rgbd_no_imu()
    return base.replace(planner=dataclasses.replace(
        base.planner, gt_stall_abort=True))


def rgbd_ba() -> Config:
    """``rgbd_no_imu`` plus the sliding-window local BA at 1 Hz: the
    RGB-D-only estimator is the case that structurally needs multi-view
    refinement (the ``rgbd_ba`` mode of ``tools/calibrate.py``)."""
    base = rgbd_no_imu()
    return base.replace(vio=dataclasses.replace(base.vio,
                                                enable_local_ba=True))
