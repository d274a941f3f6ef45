"""v55 pose-fusion relay state (``nclt_slam_tpu/fusion/relay.py``).

The repeat carry holds it on every path; GT localization only initialises
it.  ``fusion_tick``/``anchor_update`` come with the ours-mode slice of the
port.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nclt_slam_tpu_torch.config import FusionConfig

ALIGN_FIELDS = 10  # sx sy sz qx qy qz qw gt_x gt_y gt_yaw


class FusionState(NamedTuple):
    enc_xy: torch.Tensor          # (B, 2)
    enc_yaw: torch.Tensor
    enc_total_dist: torch.Tensor
    prev_gt_xy: torch.Tensor      # (B, 2)
    initialized: torch.Tensor     # bool
    T_nav_slam: torch.Tensor      # (B, 4, 4)
    committed: torch.Tensor       # bool
    align_buf: torch.Tensor       # (B, align_window, ALIGN_FIELDS)
    align_n: torch.Tensor         # int32
    align_gt0: torch.Tensor       # (B, 2)
    align_gt0_set: torch.Tensor   # bool
    prev_slam_xz: torch.Tensor    # (B, 2)
    have_prev_slam: torch.Tensor  # bool
    frozen_count: torch.Tensor    # int32
    anchor_xy: torch.Tensor       # (B, 2)
    anchor_std: torch.Tensor
    anchor_tick: torch.Tensor     # int32
    has_anchor: torch.Tensor      # bool
    strong_streak: torch.Tensor   # int32
    prev_nav: torch.Tensor        # (B, 3)
    have_prev_nav: torch.Tensor   # bool
    pub_nav: torch.Tensor         # (B, 3)
    compass_bias: torch.Tensor    # (B,)


def init_fusion(cfg: FusionConfig, batch: int, device=None) -> FusionState:
    B = batch
    z = dict(device=device)
    f = torch.zeros(B, **z)
    zb = torch.zeros(B, dtype=torch.bool, **z)
    zi = torch.zeros(B, dtype=torch.int32, **z)
    return FusionState(
        enc_xy=torch.zeros(B, 2, **z), enc_yaw=f, enc_total_dist=f.clone(),
        prev_gt_xy=torch.zeros(B, 2, **z), initialized=zb,
        T_nav_slam=torch.eye(4, **z).expand(B, 4, 4).clone(),
        committed=zb.clone(),
        align_buf=torch.zeros(B, cfg.align_window, ALIGN_FIELDS, **z),
        align_n=zi, align_gt0=torch.zeros(B, 2, **z),
        align_gt0_set=zb.clone(),
        prev_slam_xz=torch.zeros(B, 2, **z), have_prev_slam=zb.clone(),
        frozen_count=zi.clone(),
        anchor_xy=torch.zeros(B, 2, **z), anchor_std=f + 999.0,
        anchor_tick=zi - 10 ** 6, has_anchor=zb.clone(),
        strong_streak=zi.clone(),
        prev_nav=torch.zeros(B, 3, **z), have_prev_nav=zb.clone(),
        pub_nav=torch.zeros(B, 3, **z),
        compass_bias=f.clone(),
    )
