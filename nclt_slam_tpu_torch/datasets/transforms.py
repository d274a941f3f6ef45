"""Composable point-cloud transforms — the augmentation pipeline of the
place-recognition stack (``nclt_slam_tpu/datasets/transforms.py``; the
reference's ``datasets/nclt_kaggle/src/datasets/transforms.py``).

- every transform is a pure function ``(key, points, mask) -> (points,
  mask)`` on ``core/prng.py`` keys, so a pipeline reproduces the JAX
  package's draws from the same key;
- shapes are static: "subsample", "voxel downsample" and "remove ground"
  mask points out instead of shrinking N;
- a key with leading batch dimensions maps over them, like ``jax.vmap``:
  ``points`` (..., N, C) and ``mask`` (..., N) carry the same leading
  dimensions as the key (..., 2), so ``apply_batch`` is one batched call;
- ``compose`` chains transforms, splitting the key per stage;
- ``build_transforms`` keeps the reference's config-dict keys.

``points`` has xyz in its first 3 columns; extra columns (intensity) pass
through untouched.  Parity with the JAX package: ``random_subsample`` ranks
its uniform scores with a stable sort, as ``jnp.argsort`` does (ties occur
among 2**23 float32 mantissas at thousands of points), and
``voxel_downsample`` hashes in int32 with wrapping products and a floor
modulo, electing the first point of each slot with a scatter-min.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from nclt_slam_tpu_torch.core import prng

__all__ = [
    "random_rotation", "random_flip", "random_jitter", "random_subsample",
    "voxel_downsample", "normalize", "remove_ground", "compose",
    "build_transforms", "apply_batch",
]

_DEG2RAD = float(np.float32(np.pi / 180))


def _with_xyz(points, xyz):
    if points.shape[-1] > 3:
        return torch.cat([xyz, points[..., 3:]], -1)
    return xyz


def random_rotation(key, points, mask, max_angle_deg: float = 180.0):
    """Random rotation about +Z (transforms.py RandomRotation)."""
    ang = prng.uniform(key, (), -max_angle_deg, max_angle_deg) * _DEG2RAD
    c, s = torch.cos(ang), torch.sin(ang)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    R = torch.stack([torch.stack([c, -s, zero], -1),
                     torch.stack([s, c, zero], -1),
                     torch.stack([zero, zero, one], -1)], -2)  # (..., 3, 3)
    return _with_xyz(points, points[..., :3] @ R.transpose(-1, -2)), mask


def random_flip(key, points, mask, prob: float = 0.5):
    """Random X and/or Y mirror (transforms.py RandomFlip)."""
    kx, ky = prng.split(key).unbind(-2)
    sx = torch.where(prng.bernoulli(kx, prob, ()), -1.0, 1.0)
    sy = torch.where(prng.bernoulli(ky, prob, ()), -1.0, 1.0)
    scale = torch.stack([sx, sy, torch.ones_like(sx)], -1)[..., None, :]
    return _with_xyz(points, points[..., :3] * scale), mask


def random_jitter(key, points, mask, sigma: float = 0.01, clip: float = 0.05):
    """Clipped Gaussian per-point noise (transforms.py RandomJitter)."""
    n = points.shape[-2]
    noise = torch.clamp(sigma * prng.normal(key, (n, 3)), -clip, clip)
    return _with_xyz(points, points[..., :3] + noise), mask


def random_subsample(key, points, mask, num_points: int = 4096):
    """Keep a random ``num_points``-subset of the live points, as a mask
    update (transforms.py RandomSubsample, static-shape form)."""
    n = mask.shape[-1]
    score = prng.uniform(key, (n,))
    score = torch.where(mask, score, torch.full_like(score, float("inf")))
    order = torch.argsort(score, dim=-1, stable=True)
    ranks = torch.arange(n, device=order.device).expand_as(order)
    rank = torch.empty_like(order).scatter_(-1, order, ranks)
    return points, (rank < num_points) & mask


_VOXEL_HASH = 1 << 18
_INT32_MAX = 2 ** 31 - 1


def voxel_downsample(key, points, mask, voxel_size: float = 0.1):
    """Keep one point per occupied voxel (transforms.py VoxelDownsample).

    Static-shape form: voxel ids hash into a 2^18 table and a scatter-min
    elects one surviving point per slot.  Hash collisions drop a point
    spuriously (~N/2^18 odds), as in the JAX package."""
    del key
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, which rounds some quotients differently
    size = torch.tensor(voxel_size, dtype=points.dtype, device=points.device)
    v = torch.floor(points[..., :3] / size).to(torch.int32)
    # int32 products wrap as XLA's do; % is a floor modulo (non-negative)
    h = ((v[..., 0] * 73856093) ^ (v[..., 1] * 19349663)
         ^ (v[..., 2] * 83492791)) % _VOXEL_HASH
    h = h.to(torch.int64)
    n = mask.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=mask.device
                       ).expand_as(mask)
    table = torch.full(mask.shape[:-1] + (_VOXEL_HASH,), _INT32_MAX,
                       dtype=torch.int32, device=mask.device)
    table.scatter_reduce_(-1, h, torch.where(mask, idx, _INT32_MAX), "amin")
    keep = (torch.gather(table, -1, h) == idx) & mask
    return points, keep


def normalize(key, points, mask, center: bool = True, scale: bool = False):
    """Center (and optionally unit-scale) the live points
    (transforms.py Normalize)."""
    del key
    w = mask.to(points.dtype)[..., None]
    n = torch.clamp_min(w.sum(-2, keepdim=True), 1.0)
    xyz = points[..., :3]
    if center:
        xyz = xyz - (xyz * w).sum(-2, keepdim=True) / n
    if scale:
        r = torch.sqrt(((xyz ** 2).sum(-1) * w[..., 0]).amax(-1))
        xyz = xyz / torch.clamp_min(r, 1e-6)[..., None, None]
    return _with_xyz(points, xyz), mask


def remove_ground(key, points, mask, threshold: float = -1.5):
    """Mask out points below a z threshold (transforms.py RemoveGround —
    NCLT's body frame is z-down, hence the negative default)."""
    del key
    return points, mask & (points[..., 2] > threshold)


def compose(*stages):
    """Chain ``(key, points, mask) -> (points, mask)`` stages, splitting the
    key per stage (the reference's Compose)."""

    def run(key, points, mask):
        keys = prng.split(key, max(len(stages), 1))
        for i, stage in enumerate(stages):
            points, mask = stage(keys[..., i, :], points, mask)
        return points, mask

    return run


def build_transforms(config: dict, is_train: bool = True):
    """Config-dict factory with the reference's keys
    (transforms.py build_transforms:169-195)."""
    pc = config.get("point_cloud", {})
    aug = config.get("augmentation", {})
    stages = []
    if pc.get("remove_ground", False):
        stages.append(partial(remove_ground,
                              threshold=pc.get("ground_threshold", -1.5)))
    if pc.get("voxel_size"):
        stages.append(partial(voxel_downsample, voxel_size=pc["voxel_size"]))
    if is_train:
        if aug.get("random_rotation", False):
            stages.append(partial(random_rotation,
                                  max_angle_deg=aug.get("rotation_range",
                                                        180.0)))
        if aug.get("random_flip", False):
            stages.append(random_flip)
        if aug.get("jitter"):
            stages.append(partial(random_jitter, sigma=aug["jitter"]))
    stages.append(partial(random_subsample,
                          num_points=pc.get("max_points", 4096)))
    return compose(*stages)


def apply_batch(pipeline, key, points, mask):
    """A pipeline over a batch, points (B, N, C), mask (B, N): one key a
    scan, split from ``key`` as ``jax.random.split`` does."""
    return pipeline(prng.split(key, points.shape[0]), points, mask)
