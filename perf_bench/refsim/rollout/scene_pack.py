"""Packing scene/route/drop data into the fixed tensors the rollouts
consume (``nclt_slam_tpu/rollout/scene_pack.py``)."""

from __future__ import annotations

import hashlib
from typing import NamedTuple

import numpy as np
import torch

from refsim import config as cfg_mod
from refsim.config import Config
from refsim.planning.dispatcher import subsample_waypoints
from refsim.scene.colliders import SceneColliders
from refsim.scene.obstacles import RouteDrops, no_drops
from refsim.scene.routes import Route
from refsim.scene.terrain import terrain_height
from refsim.sensors.features import (
    build_scene_features,
    resample_session,
    session_shift_masks,
)


class PackedScene(NamedTuple):
    """Static collider tensors: scene colliders followed by the route's
    drop set (``drop_mask`` marks the drop slots), plus the persistent
    visual feature points.  Descriptors are int64 holding uint32."""

    xy: torch.Tensor          # (N, 2)
    radius: torch.Tensor      # (N,)
    base_z: torch.Tensor      # (N,)
    height: torch.Tensor      # (N,)
    valid: torch.Tensor       # (N,)
    drop_mask: torch.Tensor   # (N,) True for drop slots
    feat_xyz: torch.Tensor    # (S, 3) scene feature points
    feat_desc: torch.Tensor   # (S, W) descriptors
    feat_owner: torch.Tensor  # (S,) owning collider index
    feat_valid: torch.Tensor  # (S,)
    feat_pkeep: torch.Tensor  # (S,) per-tick keep probability
    feat_view_thr: torch.Tensor    # (S, 256) per-bit angular thresholds
    feat_view_alpha: torch.Tensor  # (S,) anchor azimuths


class PackedRoute(NamedTuple):
    dense_xy: torch.Tensor    # (DENSE_CAP, 2)
    n_dense: torch.Tensor     # () int32
    spawn: torch.Tensor       # (2,)
    spawn_yaw: torch.Tensor   # ()
    turnaround: torch.Tensor  # (2,)
    wps: torch.Tensor         # (max_waypoints, 2) 4 m subsample
    n_wps: torch.Tensor       # () int32


_PACK_CACHE: dict = {}


def _pack_numpy(scene: SceneColliders, drops: RouteDrops, cfg: Config,
                feat_seed: int, session: int) -> PackedScene:
    xy = np.concatenate([scene.xy, drops.xy], 0)
    radius = np.concatenate([scene.radius, drops.radius], 0)
    height = np.concatenate([scene.height, drops.height], 0)
    valid = np.concatenate([scene.valid, drops.valid], 0)
    base_z = terrain_height(torch.from_numpy(xy[:, 0]),
                            torch.from_numpy(xy[:, 1])).numpy()
    drop_mask = np.concatenate(
        [np.zeros(len(scene.xy), bool), np.ones(len(drops.xy), bool)], 0)
    feats = build_scene_features(xy, radius, base_z, height, valid,
                                 cfg.landmarks, seed=feat_seed)
    desc = feats.desc
    if session != 0:
        # repeat session: detector resample, weaker detector response, and
        # the per-feature appearance-shift XOR masks (see the JAX package)
        feats = resample_session(feats, cfg.landmarks,
                                 seed=feat_seed * 131 + session)
        feats = feats._replace(
            pkeep=feats.pkeep * cfg.landmarks.session_pkeep_scale)
        desc = feats.desc
        if cfg.landmarks.session_shift_bits > 0:
            desc = desc ^ session_shift_masks(
                desc.shape, cfg.landmarks.session_shift_bits,
                seed=feat_seed * 7919 + session)
    return PackedScene(
        xy=xy, radius=radius, base_z=base_z, height=height, valid=valid,
        drop_mask=drop_mask, feat_xyz=feats.xyz,
        feat_desc=desc.astype(np.int64), feat_owner=feats.owner,
        feat_valid=feats.valid, feat_pkeep=feats.pkeep,
        feat_view_thr=feats.view_thr, feat_view_alpha=feats.view_alpha)


def pack_scene(scene: SceneColliders, drops: RouteDrops | None = None,
               cfg: Config | None = None, feat_seed: int = 123,
               session: int = 0, *, device) -> PackedScene:
    """``session`` selects the appearance epoch: 0 = teach; a non-zero
    session is the repeat drive's (resampled detector, shifted
    descriptors).  Memoised on the host by content: a campaign build packs
    the same scene 30 times."""
    cfg = cfg or cfg_mod.DEFAULT
    if drops is None:
        drops = no_drops()
    hsh = hashlib.sha1()
    for a in (scene.xy, scene.radius, scene.height, scene.valid,
              drops.xy, drops.radius, drops.height, drops.valid):
        arr = np.ascontiguousarray(a)
        hsh.update(repr((arr.shape, arr.dtype.str)).encode())
        hsh.update(arr.tobytes())
    key = (hsh.hexdigest(), cfg.landmarks, feat_seed, session)
    packed = _PACK_CACHE.get(key)
    if packed is None:
        while len(_PACK_CACHE) >= 16:
            _PACK_CACHE.pop(next(iter(_PACK_CACHE)))
        packed = _pack_numpy(scene, drops, cfg, feat_seed, session)
        _PACK_CACHE[key] = packed
    return PackedScene(*(torch.as_tensor(a).to(device) for a in packed))


def pack_route(route: Route, cfg: Config, device) -> PackedRoute:
    wps, n_wps = subsample_waypoints(route.dense_xy, route.n_dense,
                                     cfg.planner)

    def t(x, dtype):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    return PackedRoute(
        dense_xy=t(route.dense_xy, torch.float32),
        n_dense=t(route.n_dense, torch.int32),
        spawn=t(route.spawn, torch.float32),
        spawn_yaw=t(route.spawn_yaw, torch.float32),
        turnaround=t(route.turnaround, torch.float32),
        wps=t(wps, torch.float32),
        n_wps=t(n_wps, torch.int32),
    )
