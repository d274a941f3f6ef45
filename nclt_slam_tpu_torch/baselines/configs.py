"""Campaign baseline configs (``nclt_slam_tpu/baselines/configs.py``): config
points over the same rollout, repeated off the ours-stack teach artefacts.

``stock_nav2`` (the stock Nav2 stack) comes with the stock slice of the
port.
"""

from __future__ import annotations

import dataclasses

from nclt_slam_tpu_torch import config as cfg_mod
from nclt_slam_tpu_torch.config import Config


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
