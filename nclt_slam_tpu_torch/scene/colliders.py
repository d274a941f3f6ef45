"""Packed scene colliders, read from the JAX package's scene cache.

``nclt_slam_tpu/scene/colliders.py`` generates the walled forest scene
procedurally and caches it as ``nclt_slam_tpu/scene/data/scene_seed*.npz``.
The port reads that cache (a file, not a module: nothing of the JAX package
is imported); regenerating a scene is not part of the port yet, so a missing
cache raises.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np

CAPACITY = 1536

DATA_DIR = Path(__file__).resolve().parents[2] / "nclt_slam_tpu" / "scene" / "data"


class SceneColliders(NamedTuple):
    xy: np.ndarray       # (CAPACITY, 2) float32
    radius: np.ndarray   # (CAPACITY,) float32
    height: np.ndarray   # (CAPACITY,) float32
    kind: np.ndarray     # (CAPACITY,) int32
    valid: np.ndarray    # (CAPACITY,) bool

    @property
    def count(self) -> int:
        return int(self.valid.sum())


_scene_cache: dict[int, SceneColliders] = {}


def default_scene(seed: int = 7) -> SceneColliders:
    """The walled scene every rollout consumer uses (cached npz)."""
    if seed not in _scene_cache:
        p = DATA_DIR / f"scene_seed{seed}.npz"
        if not p.is_file():
            raise FileNotFoundError(
                f"{p} is missing; generate it with the JAX package "
                f"(nclt_slam_tpu.scene.default_scene({seed}))")
        z = np.load(p)
        _scene_cache[seed] = SceneColliders(
            xy=z["xy"], radius=z["radius"], height=z["height"],
            kind=z["kind"], valid=z["valid"])
    return _scene_cache[seed]
