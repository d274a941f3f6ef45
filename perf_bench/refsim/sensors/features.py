"""Feature observation model — the framework's ORB replacement.

Port of ``nclt_slam_tpu/sensors/features.py``.  The scene carries persistent
visual landmarks: every collider exposes a ring of surface feature points
with fixed 256-bit binary descriptors.  ``build_scene_features``,
``resample_session`` and ``session_shift_masks`` are offline numpy (copied
from the JAX package, same RandomState streams); ``observe`` projects the
visible points through the pinhole camera per tick, on tensors with a
leading route dimension, and draws its noise from the threefry port so the
same key gives the same observation as the JAX package.
``cross_check_match`` is the mutual-nearest-neighbour Hamming matcher, in
this copy the plain version on every device (``ops/hamming.py``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from refsim.config import CameraConfig, LandmarkConfig
from refsim.core import prng
from refsim.ops.hamming import cross_check
from refsim.scene.terrain import terrain_height
from refsim.sensors.depth import camera_pose

FEATS_PER_OBJ = 24  # 1/4 on the trunk, 3/4 on the ground apron around it
# (12 starved the anchor funnel: stored 44 / live 109 / mutual ~11 ->
#  inliers pinned ~16 vs the CSV's 31.8; real ORB frames carry ~1000
#  corners and the recorder stores 500 — r3 calibration)
_TRUNK_FEATS = 6    # features on the collider wall; the rest are apron


class SceneFeatures(NamedTuple):
    """numpy arrays from ``build_scene_features``; tensors with a leading
    route dimension in ``observe`` (descriptors as int64 holding uint32)."""

    xyz: object          # (S, 3) world feature points
    desc: object         # (S, desc_words) uint32 descriptors
    owner: object        # (S,) collider index
    valid: object        # (S,)
    pkeep: object        # (S,) per-tick keep probability (clutter dropout)
    view_thr: object     # (S, 32*desc_words) uint8 per-bit angular
    #                      thresholds (continuous viewpoint decorrelation)
    view_alpha: object   # (S,) per-feature anchor azimuth [rad]


GROUND_DENSITY = 0.6  # forest-floor texture features per m^2


def build_scene_features(obs_xy: np.ndarray, obs_r: np.ndarray,
                         obs_base_z: np.ndarray, obs_h: np.ndarray,
                         obs_valid: np.ndarray, cfg: LandmarkConfig,
                         seed: int = 123,
                         ground_density: float = GROUND_DENSITY,
                         bounds=None) -> SceneFeatures:
    """Deterministic surface feature points + descriptors (numpy, offline;
    a copy of the JAX package's generator, returning numpy arrays).

    Besides the per-collider trunk/apron rings, a uniform forest-floor
    texture field (roots, grass tufts, leaf litter — what real ORB latches
    onto everywhere in the reference's forest) covers the scene bounds with
    ``ground_density`` points/m^2 so the observation never starves between
    tree clusters.  Ground features carry owner=-1: they never disappear
    with obstacle removal."""
    rng = np.random.RandomState(seed)
    N = len(obs_xy)
    S = N * FEATS_PER_OBJ
    owner = np.repeat(np.arange(N, dtype=np.int32), FEATS_PER_OBJ)
    valid = np.repeat(np.asarray(obs_valid, bool), FEATS_PER_OBJ)
    half = _TRUNK_FEATS
    # One block draw reproducing the original per-feature loop's RNG stream
    # exactly (uniform(a,b) = a + (b-a)*random_sample in numpy): per
    # collider the draw order is [ang, frac] x half then [ang, rad, zj] x
    # (FEATS_PER_OBJ - half).  The scalar double-loop version of this took
    # seconds per call x 30 pack_scene calls per campaign build.
    n_ap = FEATS_PER_OBJ - half
    draws = rng.random_sample((N, 2 * half + 3 * n_ap))
    tr = draws[:, : 2 * half].reshape(N, half, 2)
    ap = draws[:, 2 * half:].reshape(N, n_ap, 3)
    oxy = np.asarray(obs_xy, np.float64)
    orad = np.asarray(obs_r, np.float64)
    # trunk/surface features on the collider wall
    ang_t = 2.0 * np.pi * tr[:, :, 0]
    frac = 0.15 + (0.9 - 0.15) * tr[:, :, 1]
    t_xyz = np.stack([
        oxy[:, None, 0] + orad[:, None] * np.cos(ang_t),
        oxy[:, None, 1] + orad[:, None] * np.sin(ang_t),
        obs_base_z[:, None] + frac * np.maximum(obs_h, 0.3)[:, None],
    ], -1)
    # ground-texture features (roots, grass, debris) on the apron around
    # the collider — these are what survives the recorder's below-horizon
    # gate, like real forest-floor ORB
    ang_a = 2.0 * np.pi * ap[:, :, 0]
    rad = orad[:, None] + (0.3 + (2.0 - 0.3) * ap[:, :, 1])
    a_xyz = np.stack([
        oxy[:, None, 0] + rad * np.cos(ang_a),
        oxy[:, None, 1] + rad * np.sin(ang_a),
        obs_base_z[:, None] + 0.02 + (0.15 - 0.02) * ap[:, :, 2],
    ], -1)
    xyz = np.concatenate([t_xyz, a_xyz], 1).reshape(S, 3).astype(np.float32)
    if ground_density > 0:
        act = np.asarray(obs_valid, bool)
        ref_xy = obs_xy[act] if act.any() else np.zeros((1, 2))
        if bounds is None:
            bounds = (ref_xy[:, 0].min() - 15, ref_xy[:, 0].max() + 15,
                      ref_xy[:, 1].min() - 15, ref_xy[:, 1].max() + 15)
        x0, x1, y0, y1 = bounds
        G = int((x1 - x0) * (y1 - y0) * ground_density)
        gx = rng.uniform(x0, x1, G).astype(np.float32)
        gy = rng.uniform(y0, y1, G).astype(np.float32)
        gz = terrain_height(torch.from_numpy(gx),
                            torch.from_numpy(gy)).numpy() + \
            rng.uniform(0.02, 0.12, G).astype(np.float32)
        xyz = np.concatenate([xyz, np.stack([gx, gy, gz], -1)], 0)
        owner = np.concatenate([owner, np.full(G, -1, np.int32)], 0)
        valid = np.concatenate([valid, np.ones(G, bool)], 0)
        S += G

    # --- descriptors: texture-class codebook + per-feature unique bits ---
    # (see LandmarkConfig.desc_classes for the aliasing rationale)
    if cfg.desc_classes > 0:
        protos = rng.randint(0, 2 ** 32, size=(cfg.desc_classes, cfg.desc_words),
                             dtype=np.uint64).astype(np.uint32)
        # colliders draw a class each (nearby trees share texture classes at
        # random); every ground feature draws its own class
        coll_class = rng.randint(0, cfg.desc_classes, size=max(N, 1))
        feat_class = np.where(owner >= 0, coll_class[np.maximum(owner, 0)],
                              rng.randint(0, cfg.desc_classes, size=S))
        p_u = min(cfg.desc_unique_bits / (32.0 * cfg.desc_words), 0.5)
        u_bits = (rng.random_sample((S, cfg.desc_words, 32)) < p_u)
        weights = (1 << np.arange(32, dtype=np.uint64))
        u_mask = (u_bits * weights[None, None, :]).sum(-1).astype(np.uint32)
        desc = protos[feat_class] ^ u_mask
    else:
        desc = rng.randint(0, 2 ** 32, size=(S, cfg.desc_words),
                           dtype=np.uint64).astype(np.uint32)

    # --- clutter-scaled per-tick keep probability ---
    # count valid colliders within clutter_radius_m of each feature; dense
    # clusters (deep forest) occlude and shadow their features more often
    act = np.asarray(obs_valid, bool)
    if act.any():
        # KDTree ball counts instead of the dense (S, N) distance matrix:
        # at walled-scene scale that matrix is ~10^8 float64 (GBs of
        # intermediates) and dominated campaign build time
        from scipy.spatial import cKDTree
        cxy = np.asarray(obs_xy, np.float32)[act]
        tree = cKDTree(np.asarray(cxy, np.float64))
        clutter = tree.query_ball_point(
            np.asarray(xyz[:, :2], np.float64), cfg.clutter_radius_m,
            return_length=True)
    else:
        clutter = np.zeros(S)
    excess = np.maximum(clutter - cfg.clutter_free_trees, 0)
    pkeep = np.clip((1.0 - cfg.feat_dropout)
                    * (1.0 - cfg.clutter_drop_per_tree * excess),
                    cfg.feat_pkeep_min, 1.0).astype(np.float32)

    # --- continuous viewpoint decorrelation (LandmarkConfig.view_bits_per_deg)
    # Per-bit random angular thresholds: the flip mask at azimuth az is
    # {bits : thr < g(Δ(az, alpha))}, nested in Δ, so two observations
    # differ by ~view_bits_per_deg * Δazimuth bits, saturating at 128.
    nbits = 32 * cfg.desc_words
    view_thr = rng.randint(0, 256, size=(S, nbits), dtype=np.uint8)
    view_alpha = rng.uniform(-np.pi, np.pi, S).astype(np.float32)

    return SceneFeatures(xyz=xyz, desc=desc, owner=owner, valid=valid,
                         pkeep=pkeep, view_thr=view_thr,
                         view_alpha=view_alpha)


class Observation(NamedTuple):
    """Fixed-size feature observation from one camera pose (per route)."""

    uv: torch.Tensor        # (B, K, 2) pixel coords
    p3d_cam: torch.Tensor   # (B, K, 3) points in the OpenCV camera frame
    desc: torch.Tensor      # (B, K, words) noisy descriptors (int64)
    feat_id: torch.Tensor   # (B, K) index into SceneFeatures
    valid: torch.Tensor     # (B, K)


def _take(x, idx):
    """Per-route gather along dim 1: x (B, S, ...) at idx (B, K)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _pymod(x, m: float):
    """``jnp.mod`` for floats: fmod, shifted into the divisor's sign."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & (r < 0), r + m, r)


def _bit_mask(bits):
    """(..., 32) bool -> (...) int64 word with bit k = bits[..., k]."""
    w = torch.arange(32, device=bits.device)
    return (bits.to(torch.int64) << w).sum(-1)


def observe(base_pos, yaw, feats: SceneFeatures, obs_valid_now,
            key, cam: CameraConfig, cfg: LandmarkConfig,
            yaw_rate=0.0, occluders=None,
            px_session_amp: float = 0.0) -> Observation:
    """Project scene features through the camera; gate, occlude, corrupt.

    base_pos (B, 3), yaw (B,), key (B, 2); feats fields (B, S, ...);
    obs_valid_now (B, N) current collider validity (features of removed
    colliders disappear); yaw_rate (B,) or a float — the commanded |w| that
    drives the rotational motion-blur degradation; occluders: optional
    (xy (B, M, 2), radius, base_z, height, active (B, M), index (M,))
    cylinders that block the line of sight (the repeat pass's drops).
    """
    B = base_pos.shape[0]
    dev = base_pos.device
    blur = torch.as_tensor(yaw_rate, dtype=torch.float32,
                           device=dev).abs().expand(B)
    origin, R_wc = camera_pose(base_pos, yaw, cam)
    rel = feats.xyz - origin[:, None, :]
    p_cam = torch.matmul(rel, R_wc)   # world->cam: R^T @ rel, row-vec form

    z = p_cam[..., 2]
    u = cam.fx * p_cam[..., 0] / z.clamp_min(1e-6) + cam.cx
    v = cam.fy * p_cam[..., 1] / z.clamp_min(1e-6) + cam.cy
    dist = torch.sqrt((p_cam * p_cam).sum(-1))

    in_img = (u >= 1) & (u < cam.width - 1) & (v >= 1) & (v < cam.height - 1)
    in_depth = (z > cam.depth_min) & (z < cam.depth_max)
    # owner -1 = ground-texture feature, never removed with obstacles
    alive = feats.valid & ((feats.owner < 0) | torch.gather(
        obs_valid_now, 1, feats.owner.clamp_min(0).to(torch.int64)))
    ks = prng.split(key, 2)
    k_drop, key = ks[:, 0], ks[:, 1]
    # rotational motion blur scales the keep probability down with |w|
    pkeep = torch.maximum(
        feats.pkeep * (1.0 - cam.blur_drop_per_radps * blur[:, None]),
        torch.tensor(cam.blur_pkeep_floor, dtype=torch.float32, device=dev))
    kept = prng.bernoulli(k_drop, pkeep)
    vis = in_img & in_depth & alive & kept

    # the max_obs nearest visible features; a stable ascending sort keeps
    # lax.top_k's lowest-index-first order among equal scores
    score = torch.where(vis, dist, torch.full_like(dist, float("inf")))
    K = cfg.max_obs_features
    S = score.shape[1]
    s_sorted, order = torch.sort(score, dim=1, stable=True)
    if S >= K:
        idx = order[:, :K]
        sel_valid = torch.isfinite(s_sorted[:, :K])
    else:
        pad = torch.zeros(B, K - S, dtype=order.dtype, device=dev)
        idx = torch.cat([order, pad], 1)
        sel_valid = torch.cat([torch.isfinite(s_sorted),
                               torch.zeros(B, K - S, dtype=torch.bool,
                                           device=dev)], 1)

    sel_xyz = _take(feats.xyz, idx)                       # (B, K, 3)
    if occluders is not None:
        oxy, orad, oz0, oh, oact, oidx = occluders
        d2d = sel_xyz[..., :2] - origin[:, None, :2]      # (B, K, 2)
        L2 = (d2d ** 2).sum(-1).clamp_min(1e-6)           # (B, K)
        mo = oxy - origin[:, None, :2]                    # (B, M, 2)
        t = (mo[:, None, :, :] * d2d[:, :, None, :]).sum(-1) / L2[..., None]
        between = (t > 0.05) & (t < 0.95)
        closest = t[..., None] * d2d[:, :, None, :]       # (B, K, M, 2)
        gap2 = ((closest - mo[:, None]) ** 2).sum(-1)     # (B, K, M)
        ray_z = origin[:, None, None, 2] + t * (
            sel_xyz[..., 2:3] - origin[:, None, None, 2])
        blocked = (between & (gap2 < (orad ** 2)[:, None]) & oact[:, None]
                   & (ray_z < (oz0 + oh)[:, None])
                   & (_take(feats.owner, idx)[..., None] != oidx)).any(-1)
        sel_valid = sel_valid & ~blocked

    # observation noise: pixel jitter + depth noise + descriptor bit flips
    k1, k2, k3, k4, k5 = prng.split(key, 5).unbind(1)
    uv = torch.stack([_take(u, idx), _take(v, idx)], -1)
    # surviving corners localize worse under blur (smeared gradients)
    px_sigma = cam.px_noise * (1.0 + cam.px_blur_per_radps * blur)
    uv = uv + px_sigma[:, None, None] * prng.normal(k1, (K, 2))
    ox, oy = origin[:, 0], origin[:, 1]
    if cam.px_bias_amp > 0:
        ub = _bias_field(ox, oy, cam.px_bias_scale_m, (0.3, 2.1, 4.4))
        vb = _bias_field(ox, oy, cam.px_bias_scale_m, (1.7, 3.9, 5.6))
        uv = uv + cam.px_bias_amp * torch.stack([ub, vb], -1)[:, None, :]
    if px_session_amp > 0:
        us = _bias_field(ox, oy, cam.px_bias_scale_m, (5.2, 1.1, 3.3))
        vs = _bias_field(ox, oy, cam.px_bias_scale_m, (0.9, 4.7, 2.4))
        uv = uv + px_session_amp * torch.stack([us, vs], -1)[:, None, :]
    p3d = _take(p_cam, idx)
    # stereo-depth error: sigma_z/z = depth_noise_rel_per_m * z
    rel_std = cam.depth_noise_rel_per_m * p3d[..., 2:3].clamp_min(0.0)
    depth_noise = 1.0 + rel_std * prng.normal(k2, (K, 1))
    p3d = p3d * depth_noise
    if cam.depth_bias_amp > 0:
        db = _bias_field(ox, oy, cam.depth_bias_scale_m, (2.6, 0.8, 5.1))
        p3d = p3d * (1.0 + cam.depth_bias_amp * db)[:, None, None]
    if cam.depth_outlier_frac > 0:
        is_out = prng.bernoulli(k4, cam.depth_outlier_frac, (K, 1))
        out_scale = prng.uniform(k5, (K, 1), cam.depth_outlier_lo,
                                 cam.depth_outlier_hi)
        p3d = torch.where(is_out, p3d * out_scale, p3d)

    desc = _take(feats.desc, idx)
    # continuous viewpoint corruption: flip every bit whose angular
    # threshold lies below this view's distance from the feature's anchor
    # azimuth (nested masks: ~view_bits_per_deg flips per degree)
    if cfg.view_bits_per_deg > 0:
        rel_f = origin[:, None, :2] - sel_xyz[..., :2]
        az = torch.atan2(rel_f[..., 1], rel_f[..., 0])
        dal = (_pymod(az - _take(feats.view_alpha, idx) + math.pi,
                      2.0 * math.pi) - math.pi).abs()       # (B, K) [0, pi]
        g = 0.5 * torch.clamp_max(
            dal * (180.0 / math.pi) * cfg.view_bits_per_deg / 128.0, 1.0)
        thr = _take(feats.view_thr, idx).to(torch.float32) / 255.0
        flips = thr < g[..., None] - 1e-7
        desc = desc ^ _bit_mask(flips.reshape(B, K, cfg.desc_words, 32))
    p_flip = cfg.desc_noise_bits / (32.0 * cfg.desc_words)
    flip_bits = prng.bernoulli(k3, p_flip, (K, cfg.desc_words, 32))
    desc = desc ^ _bit_mask(flip_bits)

    return Observation(uv=uv, p3d_cam=p3d, desc=desc,
                       feat_id=idx.to(torch.int32), valid=sel_valid)


def resample_session(feats: SceneFeatures, cfg, seed: int) -> SceneFeatures:
    """Cross-session detector resample (LandmarkConfig.session_overlap).

    Keeps each feature with probability ``session_overlap``; the rest are
    replaced by DIFFERENT physical corners — position jittered on the same
    surface, fresh descriptor/viewpoint state — so a teach-time landmark
    snapshot only partially exists in the repeat world.  Host-side numpy,
    runs once at scene-pack time."""
    p = float(cfg.session_overlap)
    if p >= 1.0:
        return feats
    xyz = np.asarray(feats.xyz).copy()
    desc = np.asarray(feats.desc).copy()
    thr = np.asarray(feats.view_thr).copy()
    alpha = np.asarray(feats.view_alpha).copy()
    S, W = desc.shape
    rng = np.random.RandomState((seed * 31 + 17) & 0x7FFFFFFF)
    replace = rng.random_sample(S) >= p
    n = int(replace.sum())
    if n == 0:
        return feats
    # a different corner nearby: up to ~0.5 m vertically on the trunk /
    # ~0.3 m laterally on the ground patch
    xyz[replace] += np.column_stack([
        rng.normal(0, 0.15, n), rng.normal(0, 0.15, n),
        rng.normal(0, 0.35, n)]).astype(np.float32)
    weights = (1 << np.arange(32, dtype=np.uint64))
    p_flip = 0.5  # a different physical point: descriptor uncorrelated
    flips = (rng.random_sample((n, W, 32)) < p_flip)
    desc[replace] ^= (flips * weights[None, None, :]).sum(-1).astype(np.uint32)
    thr[replace] = rng.randint(0, 256, size=(n, thr.shape[1]), dtype=np.uint8)
    alpha[replace] = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    return feats._replace(xyz=xyz, desc=desc, view_thr=thr, view_alpha=alpha)


def session_shift_masks(shape, bits, seed: int) -> np.ndarray:
    """Fixed per-feature XOR masks with ~``bits`` set bits out of 32*W —
    the cross-session appearance gap (LandmarkConfig.session_shift_bits).
    ``bits`` may be a scalar or a per-feature (S,) array (the per-collider
    appearance-death model passes bimodal values).
    Host-side numpy: runs once at scene-pack time."""
    S, W = shape
    rng = np.random.RandomState(seed & 0x7FFFFFFF)
    p = np.minimum(np.asarray(bits, np.float64) / (32.0 * W), 0.5)
    p = np.broadcast_to(p, (S,))[:, None, None]
    bits_arr = rng.random_sample((S, W, 32)) < p
    weights = (1 << np.arange(32, dtype=np.uint64))
    return (bits_arr * weights[None, None, :]).sum(-1).astype(np.uint32)


def _bias_field(x, y, scale, phases):
    """Smooth ~unit-variance scalar field: three incommensurate plane
    waves of wavelength ``scale`` (a fixed, spatially varying sensor
    calibration state)."""
    k = 2.0 * math.pi / scale
    t1 = torch.sin(k * (0.93 * x + 0.36 * y) + phases[0])
    t2 = torch.sin(k * (-0.41 * x + 0.91 * y) + phases[1])
    t3 = torch.sin(k * (0.55 * x - 0.83 * y) + phases[2])
    return (t1 + t2 + t3) * 0.577


def cross_check_match(desc_a, valid_a, desc_b, valid_b, max_dist: int = 64,
                      return_dist: bool = False, site: str = "other"):
    """BFMatcher(crossCheck=True) equivalent: mutual nearest neighbours
    under a Hamming cap, per route.  desc_a (B, A, W), desc_b (B, Bm, W)
    (or (B // group, Bm, W): see ``ops.hamming.cross_check``).  Returns
    (match_idx (B, A) int64, matched (B, A)); with ``return_dist`` also the
    per-a best distance (the novelty gate)."""
    best_ab, matched, best_d = cross_check(desc_a, valid_a, desc_b, valid_b,
                                           max_dist=max_dist, site=site)
    if return_dist:
        return best_ab.long(), matched, best_d
    return best_ab.long(), matched
