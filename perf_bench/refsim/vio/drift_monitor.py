"""Live teach drift monitor — the online abort gate
(``nclt_slam_tpu/vio/drift_monitor.py``).

During a teach run it samples (VIO, GT) xy pairs into a ring buffer,
periodically aligns the VIO track to GT with a handedness-robust 2-D
Procrustes (all four axis flips, rotation + translation) and aborts the
teach pass when the post-alignment maximum residual exceeds the limit after
a settling period.  Tensors carry a leading route dimension.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from refsim.config import TeachConfig


class DriftMonitorState(NamedTuple):
    buf_vio: torch.Tensor    # (B, cap, 2) raw VIO xy samples
    buf_gt: torch.Tensor     # (B, cap, 2) GT xy samples
    n: torch.Tensor          # (B,) int32 total samples pushed
    drift_max: torch.Tensor  # (B,) last computed max residual
    drift_mean: torch.Tensor  # (B,)
    aborted: torch.Tensor    # (B,) bool — gate fired


def init_drift_monitor(cfg: TeachConfig, batch: int,
                       device) -> DriftMonitorState:
    C, B = cfg.drift_buf_cap, batch
    return DriftMonitorState(
        buf_vio=torch.zeros(B, C, 2, device=device),
        buf_gt=torch.zeros(B, C, 2, device=device),
        n=torch.zeros(B, dtype=torch.int32, device=device),
        drift_max=torch.zeros(B, device=device),
        drift_mean=torch.zeros(B, device=device),
        aborted=torch.zeros(B, dtype=torch.bool, device=device))


def push_sample(st: DriftMonitorState, vio_xy, gt_xy) -> DriftMonitorState:
    """Append one (VIO, GT) xy pair per route at the ring cursor."""
    C = st.buf_vio.shape[1]
    at = (torch.arange(C, device=st.n.device) == (st.n % C)[:, None])[..., None]
    return st._replace(
        buf_vio=torch.where(at, vio_xy[:, None], st.buf_vio),
        buf_gt=torch.where(at, gt_xy[:, None], st.buf_gt),
        n=st.n + 1)


_FLIPS = ((1.0, 1.0), (-1.0, 1.0), (1.0, -1.0), (-1.0, -1.0))


def procrustes_drift_masked(vio_xy, gt_xy, w):
    """Masked 4-flip 2-D Procrustes residual (max, mean) per route.

    vio_xy, gt_xy (B, C, 2); w (B, C) 0/1 sample validity.  Rotation +
    translation only; the axis-sign combination with the lowest mean
    residual wins (the first on ties)."""
    wsum = w.sum(-1).clamp_min(1e-6)[:, None]              # (B, 1)
    xg, yg = gt_xy[..., 0], gt_xy[..., 1]
    cxg = (xg * w).sum(-1, keepdim=True) / wsum
    cyg = (yg * w).sum(-1, keepdim=True) / wsum
    dxg, dyg = (xg - cxg)[:, None], (yg - cyg)[:, None]    # (B, 1, C)
    flips = torch.tensor(_FLIPS, device=vio_xy.device)
    xv = vio_xy[:, None, :, 0] * flips[:, 0:1]             # (B, 4, C)
    yv = vio_xy[:, None, :, 1] * flips[:, 1:2]
    w4, ws4 = w[:, None], wsum[:, None]
    dxv = xv - (xv * w4).sum(-1, keepdim=True) / ws4
    dyv = yv - (yv * w4).sum(-1, keepdim=True) / ws4
    a = (w4 * (dxv * dxg + dyv * dyg)).sum(-1)             # (B, 4)
    b = (w4 * (dxv * dyg - dyv * dxg)).sum(-1)
    th = torch.atan2(b, a)
    c, s = torch.cos(th)[..., None], torch.sin(th)[..., None]
    rx = c * dxv - s * dyv + cxg[:, None]
    ry = s * dxv + c * dyv + cyg[:, None]
    err = torch.hypot(rx - xg[:, None], ry - yg[:, None])  # (B, 4, C)
    mean_err = (err * w4).sum(-1) / wsum                   # (B, 4)
    best = mean_err.argmin(-1)
    rows = torch.arange(err.shape[0], device=err.device)
    best_err = err[rows, best]
    d_max = torch.where(w > 0, best_err, torch.zeros_like(best_err)).amax(-1)
    return d_max, mean_err[rows, best]


def check_drift(st: DriftMonitorState, tick: int, cfg: TeachConfig,
                nav_hz: float = 10.0) -> DriftMonitorState:
    """Periodic gate evaluation (the caller applies the check cadence).
    Settling: no abort before drift_settling_s."""
    C = st.buf_vio.shape[1]
    w = (torch.arange(C, device=st.n.device) < st.n[:, None]).to(
        torch.float32)
    enough = st.n >= 20
    d_max, d_mean = procrustes_drift_masked(st.buf_vio, st.buf_gt, w)
    d_max = torch.where(enough, d_max, torch.zeros_like(d_max))
    d_mean = torch.where(enough, d_mean, torch.zeros_like(d_mean))
    settled = float(tick) >= cfg.drift_settling_s * nav_hz
    fire = enough & (d_max > cfg.drift_abort_m) & settled
    return st._replace(drift_max=d_max, drift_mean=d_mean,
                       aborted=st.aborted | fire)
