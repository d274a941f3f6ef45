"""VIO tracker state (``nclt_slam_tpu/vio/tracker.py``).

The rollout carries the VIO state on every path; the GT-localized slice
only initialises it.  ``vio_frame`` and the pose emitters come with the VIO
slice of the port.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

MAP_CAP = 384
KF_OBS = 192


class VioState(NamedTuple):
    pos: torch.Tensor        # (B, 3) body position in VIO world (spawn frame)
    vel: torch.Tensor        # (B, 3)
    q: torch.Tensor          # (B, 4) world_from_body
    map_xyz: torch.Tensor    # (B, MAP_CAP, 3) map points (VIO world)
    map_desc: torch.Tensor   # (B, MAP_CAP, W) int64 holding uint32
    map_valid: torch.Tensor  # (B, MAP_CAP)
    map_age: torch.Tensor    # (B, MAP_CAP) frames since last seen
    map_obs: torch.Tensor    # (B, MAP_CAP) observation count
    next_slot: torch.Tensor  # (B,) int32 ring insertion cursor
    lost: torch.Tensor       # (B,) bool
    implaus_streak: torch.Tensor  # (B,) int32
    n_tracked: torch.Tensor  # (B,) int32 matches in the last frame
    frames: torch.Tensor     # (B,) int32
    kf_pos: torch.Tensor       # (B, K, 3)
    kf_quat: torch.Tensor      # (B, K, 4)
    kf_valid: torch.Tensor     # (B, K)
    kf_ptr: torch.Tensor       # (B,) int32 ring cursor (newest = ptr-1)
    kf_obs_slot: torch.Tensor  # (B, K, KF_OBS) map slot ids
    kf_obs_uv: torch.Tensor    # (B, K, KF_OBS, 2)
    kf_obs_z: torch.Tensor     # (B, K, KF_OBS)
    kf_obs_valid: torch.Tensor  # (B, K, KF_OBS)
    last_kf_pos: torch.Tensor  # (B, 3)
    emit_scale: torch.Tensor   # (B,) reported-trajectory scale
    emit_off: torch.Tensor     # (B, 3) reported-trajectory offset
    dist_since_event: torch.Tensor  # (B,)
    stress_streak: torch.Tensor     # (B,) int32
    starve_streak: torch.Tensor     # (B,) int32


def init_vio(desc_words: int, window_kf: int, batch: int,
             device=None) -> VioState:
    K, B = window_kf, batch
    z = dict(device=device)
    zi = torch.zeros(B, dtype=torch.int32, **z)
    q = torch.zeros(B, 4, **z)
    q[:, 3] = 1.0
    kf_quat = torch.zeros(B, K, 4, **z)
    kf_quat[..., 3] = 1.0
    return VioState(
        pos=torch.zeros(B, 3, **z), vel=torch.zeros(B, 3, **z), q=q,
        map_xyz=torch.zeros(B, MAP_CAP, 3, **z),
        map_desc=torch.zeros(B, MAP_CAP, desc_words, dtype=torch.int64, **z),
        map_valid=torch.zeros(B, MAP_CAP, dtype=torch.bool, **z),
        map_age=torch.zeros(B, MAP_CAP, dtype=torch.int32, **z),
        map_obs=torch.zeros(B, MAP_CAP, dtype=torch.int32, **z),
        next_slot=zi, lost=torch.zeros(B, dtype=torch.bool, **z),
        implaus_streak=zi.clone(), n_tracked=zi.clone(), frames=zi.clone(),
        kf_pos=torch.zeros(B, K, 3, **z), kf_quat=kf_quat,
        kf_valid=torch.zeros(B, K, dtype=torch.bool, **z),
        kf_ptr=zi.clone(),
        kf_obs_slot=torch.zeros(B, K, KF_OBS, dtype=torch.int32, **z),
        kf_obs_uv=torch.zeros(B, K, KF_OBS, 2, **z),
        kf_obs_z=torch.zeros(B, K, KF_OBS, **z),
        kf_obs_valid=torch.zeros(B, K, KF_OBS, dtype=torch.bool, **z),
        last_kf_pos=torch.full((B, 3), 1e9, **z),
        emit_scale=torch.ones(B, **z),
        emit_off=torch.zeros(B, 3, **z),
        dist_since_event=torch.zeros(B, **z),
        stress_streak=zi.clone(), starve_streak=zi.clone(),
    )
