"""Route registry, read from the JAX package's route cache.

``nclt_slam_tpu/scene/routes.py`` generates each route offline and caches it
as ``nclt_slam_tpu/scene/data/route_<name>_seed*.npz``; the port reads those
files.  A missing cache raises: route generation is not part of the port.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from nclt_slam_tpu_torch.scene.colliders import DATA_DIR

# Fixed capacity of a dense (0.8 m) route polyline incl. turnaround + return.
DENSE_CAP = 768

LT = (-90.0, 35.0)
RT = (65.0, 35.0)
LB = (-90.0, -35.0)
RB = (65.0, -35.0)

# route name -> (spawn, turnaround). Same numbers as the reference registry.
ROUTE_META = {
    "01_road":         {"spawn": (-80.0, -1.4), "turnaround": (70.5, -2.7)},
    "02_north_forest": {"spawn": (-84.4, 4.5), "turnaround": (70.4, -2.3)},
    "03_south":        {"spawn": (-94.9, -6.0), "turnaround": (69.7, -5.1)},
    "04_nw_se":        {"spawn": LT, "turnaround": RB},
    "05_ne_sw":        {"spawn": RT, "turnaround": LB},
    "06_nw_ne":        {"spawn": LT, "turnaround": RT},
    "07_se_sw":        {"spawn": RB, "turnaround": LB},
    "08_nw_sw":        {"spawn": LT, "turnaround": LB},
    "09_se_ne":        {"spawn": RB, "turnaround": RT},
    "10_nmid_smid":    {"spawn": (-20.0, 30.0), "turnaround": (24.75, -31.69)},
    "11_nw_mid":       {"spawn": (-90.0, 35.0), "turnaround": (-24.32, -12.61)},
    "12_ne_mid":       {"spawn": (65.0, 35.0), "turnaround": (-20.9, -1.84)},
    "13_cross_nws":    {"spawn": (-30.0, 20.0), "turnaround": (27.42, -15.53)},
    "14_se_mid":       {"spawn": (65.0, -35.0), "turnaround": (-0.47, 17.48)},
    "15_wmid_smid":    {"spawn": (-61.5, 8.5), "turnaround": (25.5, -31.55)},
}

ALL_ROUTES = list(ROUTE_META.keys())


class Route(NamedTuple):
    name: str
    dense_xy: np.ndarray     # (DENSE_CAP, 2) float32 — 0.8 m waypoints, padded
    n_dense: int
    spawn: tuple             # (x, y)
    spawn_yaw: float
    turnaround: tuple        # (x, y)
    turnaround_idx: int      # dense index of the hairpin apex


_route_cache: dict = {}


def get_route(name: str, seed: int = 7) -> Route:
    if name not in ROUTE_META:
        raise KeyError(name)
    key = (name, seed)
    if key not in _route_cache:
        p = DATA_DIR / f"route_{name}_seed{seed}.npz"
        if not p.is_file():
            raise FileNotFoundError(
                f"{p} is missing; generate it with the JAX package "
                f"(nclt_slam_tpu.scene.get_route({name!r}, {seed}))")
        z = np.load(p)
        _route_cache[key] = Route(
            name=name, dense_xy=z["dense_xy"], n_dense=int(z["n_dense"]),
            spawn=tuple(z["spawn"]), spawn_yaw=float(z["spawn_yaw"]),
            turnaround=tuple(z["turnaround"]),
            turnaround_idx=int(z["turnaround_idx"]))
    return _route_cache[key]
