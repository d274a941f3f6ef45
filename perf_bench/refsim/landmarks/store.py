"""Teach-time visual landmark recorder (``nclt_slam_tpu/landmarks/store.py``).

Every >= 2 m of camera displacement, snapshot the current feature
observation — camera world pose, per-feature descriptors, pixel coords and
camera-frame 3-D points — with the reference's below-horizon and
depth-patch gates, into a fixed-capacity store (the ``landmarks.pkl``
artefact).  Fields carry a leading route dimension.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from refsim.config import CameraConfig, LandmarkConfig
from refsim.sensors.features import Observation


class LandmarkStore(NamedTuple):
    """Fixed-capacity landmark array-of-structs (the landmarks.pkl pytree)."""

    cam_pos: torch.Tensor     # (B, L, 3) camera world position at record time
    cam_yaw: torch.Tensor     # (B, L) camera yaw (FLU heading)
    desc: torch.Tensor        # (B, L, F, W) int64 holding uint32
    p3d_cam: torch.Tensor     # (B, L, F, 3) feature points, OpenCV cam frame
    uv: torch.Tensor          # (B, L, F, 2)
    feat_valid: torch.Tensor  # (B, L, F)
    n_feats: torch.Tensor     # (B, L) int32
    count: torch.Tensor       # (B,) int32
    last_pos: torch.Tensor    # (B, 2) last recorded camera xy
    has_last: torch.Tensor    # (B,) bool


def init_store(cfg: LandmarkConfig, batch: int, device) -> LandmarkStore:
    L, F, W = cfg.max_landmarks, cfg.feats_per_landmark, cfg.desc_words
    z = dict(device=device)
    return LandmarkStore(
        cam_pos=torch.zeros(batch, L, 3, **z),
        cam_yaw=torch.zeros(batch, L, **z),
        desc=torch.zeros(batch, L, F, W, dtype=torch.int64, **z),
        p3d_cam=torch.zeros(batch, L, F, 3, **z),
        uv=torch.zeros(batch, L, F, 2, **z),
        feat_valid=torch.zeros(batch, L, F, dtype=torch.bool, **z),
        n_feats=torch.zeros(batch, L, dtype=torch.int32, **z),
        count=torch.zeros(batch, dtype=torch.int32, **z),
        last_pos=torch.zeros(batch, 2, **z),
        has_last=torch.zeros(batch, dtype=torch.bool, **z),
    )


def record_tick(store: LandmarkStore, obs: Observation, cam_pos, cam_yaw,
                cam: CameraConfig, cfg: LandmarkConfig) -> LandmarkStore:
    """Maybe record a landmark this tick (>= 2 m displacement trigger).
    cam_pos (B, 3), cam_yaw (B,)."""
    B = cam_pos.shape[0]
    rows = torch.arange(B, device=cam_pos.device)
    disp = torch.sqrt(((cam_pos[:, :2] - store.last_pos) ** 2).sum(-1))
    trigger = (~store.has_last) | (disp >= cfg.record_min_disp_m)
    slot_free = store.count < cfg.max_landmarks

    # reference gates: below-horizon pixels (v > 180), depth range, and the
    # 3x3 depth-patch std < 0.30 m gate (the stereo noise model's sigma_z)
    F = cfg.feats_per_landmark
    sigma_z = cam.depth_noise_rel_per_m * obs.p3d_cam[..., 2] ** 2
    gate = obs.valid & (obs.uv[..., 1] > cfg.ground_v_threshold) & \
        (sigma_z < cfg.depth_patch_std_max)
    # compact the first F gated features into the landmark slots (a stable
    # sort, as jnp.argsort is)
    order = torch.argsort((~gate).to(torch.uint8), dim=1, stable=True)
    take = order[:, :F]
    f_valid = torch.gather(gate, 1, take)
    n_ok = f_valid.sum(1)
    enough = n_ok >= cfg.record_min_feats

    do = trigger & slot_free & enough
    slot = store.count.clamp_max(cfg.max_landmarks - 1).long()

    def take_f(x):
        return x[rows[:, None], take]

    def upd(arr, new):
        out = arr.clone()
        cur = out[rows, slot]
        mask = do.reshape((B,) + (1,) * (cur.dim() - 1))
        out[rows, slot] = torch.where(mask, new.to(arr.dtype), cur)
        return out

    return LandmarkStore(
        cam_pos=upd(store.cam_pos, cam_pos),
        cam_yaw=upd(store.cam_yaw, cam_yaw),
        desc=upd(store.desc, take_f(obs.desc)),
        p3d_cam=upd(store.p3d_cam, take_f(obs.p3d_cam)),
        uv=upd(store.uv, take_f(obs.uv)),
        feat_valid=upd(store.feat_valid, f_valid),
        n_feats=upd(store.n_feats, n_ok),
        count=torch.where(do, store.count + 1, store.count),
        last_pos=torch.where(do[:, None], cam_pos[:, :2], store.last_pos),
        has_last=store.has_last | do,
    )
