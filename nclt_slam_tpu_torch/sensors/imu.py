"""Synthetic IMU state (``nclt_slam_tpu/sensors/imu.py``).

The rollout carries the IMU state on every path; the GT-localized slice
only initialises it (the per-run biases are drawn here, from the same key
split as the JAX package).  The 200 Hz ``imu_block`` comes with the VIO
slice of the port.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nclt_slam_tpu_torch.config import ImuConfig
from nclt_slam_tpu_torch.core import prng


class ImuState(NamedTuple):
    prev_pos: torch.Tensor       # (B, 3)
    prev_vel: torch.Tensor       # (B, 3) world velocity
    prev_quat: torch.Tensor      # (B, 4)
    prev_omega: torch.Tensor     # (B, 3) filtered body rate
    accel_buf: torch.Tensor      # (B, taps, 3) raw world-accel ring buffer
    accel_n: torch.Tensor        # (B,) int32 — samples in ring so far
    pos_hist: torch.Tensor       # (B, window, 3) position history ring
    pos_n: torch.Tensor          # (B,) int32
    bias_gyro: torch.Tensor      # (B, 3) constant per-run bias
    bias_accel: torch.Tensor     # (B, 3)
    initialized: torch.Tensor    # (B,) bool


def init_imu(key, cfg: ImuConfig) -> ImuState:
    """key (B, 2)."""
    B = key.shape[0]
    dev = key.device
    kg, ka = prng.split(key).unbind(1)
    quat = torch.zeros(B, 4, device=dev)
    quat[:, 3] = 1.0
    zi = torch.zeros(B, dtype=torch.int32, device=dev)
    return ImuState(
        prev_pos=torch.zeros(B, 3, device=dev),
        prev_vel=torch.zeros(B, 3, device=dev),
        prev_quat=quat,
        prev_omega=torch.zeros(B, 3, device=dev),
        accel_buf=torch.zeros(B, cfg.accel_mean_taps, 3, device=dev),
        accel_n=zi,
        pos_hist=torch.zeros(B, cfg.standstill_window, 3, device=dev),
        pos_n=zi.clone(),
        bias_gyro=cfg.gyro_bias_std * prng.normal(kg, (3,)),
        bias_accel=cfg.accel_bias_std * prng.normal(ka, (3,)),
        initialized=torch.zeros(B, dtype=torch.bool, device=dev),
    )
