"""Teach drift-monitor state (``nclt_slam_tpu/vio/drift_monitor.py``).

The teach carry holds it on every path; the GT-localized teach (no VIO)
only initialises it.  ``push_sample``/``check_drift`` come with the VIO
slice of the port.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nclt_slam_tpu_torch.config import TeachConfig


class DriftMonitorState(NamedTuple):
    buf_vio: torch.Tensor    # (B, cap, 2) raw VIO xy samples
    buf_gt: torch.Tensor     # (B, cap, 2) GT xy samples
    n: torch.Tensor          # (B,) int32 total samples pushed
    drift_max: torch.Tensor  # (B,) last computed max residual
    drift_mean: torch.Tensor  # (B,)
    aborted: torch.Tensor    # (B,) bool — gate fired


def init_drift_monitor(cfg: TeachConfig, batch: int,
                       device=None) -> DriftMonitorState:
    C, B = cfg.drift_buf_cap, batch
    return DriftMonitorState(
        buf_vio=torch.zeros(B, C, 2, device=device),
        buf_gt=torch.zeros(B, C, 2, device=device),
        n=torch.zeros(B, dtype=torch.int32, device=device),
        drift_max=torch.zeros(B, device=device),
        drift_mean=torch.zeros(B, device=device),
        aborted=torch.zeros(B, dtype=torch.bool, device=device))
