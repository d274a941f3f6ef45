"""Per-route repeat-time obstacle drops (the fault-injection axis).

The reference spawns dense cone walls + a tent for routes 01-04 and curated
prop sets (barrels/dumpsters/cardboxes/benches/...) for 05-15
(spawn_obstacles.py:24-141), then despawns them all when the turnaround
supervisor FIREs.  We generate equivalent drop sets procedurally from each
route's outbound path: cone wall groups perpendicular to the path at fixed
fractions of the outbound leg (with a bypass side left open) plus a tent,
or prop clusters for the higher routes.  Drops are packed into fixed arrays
with an ``active`` mask — supervisor FIRE simply zeroes the mask inside the
jitted rollout (no stage edits, no process signals).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from refsim.scene.routes import Route

DROP_CAP = 32

CONE_R = 0.18
CONE_H = 0.55
TENT_R = 1.6
TENT_H = 2.0

PROP_GEOM = {  # kind -> (radius, height)
    "barrel": (0.35, 0.9),
    "dumpster": (1.0, 1.3),
    "cardbox": (0.45, 0.7),
    "concrete": (0.6, 0.8),
    "trashcan": (0.3, 1.0),
    "bench": (0.8, 0.5),
    "hydrant": (0.2, 0.8),
    "railing": (0.9, 1.0),
}
PROP_KINDS = list(PROP_GEOM)


class RouteDrops(NamedTuple):
    xy: np.ndarray       # (DROP_CAP, 2)
    radius: np.ndarray   # (DROP_CAP,)
    height: np.ndarray   # (DROP_CAP,)
    valid: np.ndarray    # (DROP_CAP,) bool


def _path_frame(route: Route, frac: float):
    """Point + unit tangent + unit normal at ``frac`` of the outbound leg."""
    idx = int(frac * route.turnaround_idx)
    idx = max(1, min(idx, route.n_dense - 2))
    p = route.dense_xy[idx].astype(np.float64)
    t = route.dense_xy[idx + 1] - route.dense_xy[idx - 1]
    t = t / (np.linalg.norm(t) + 1e-9)
    n = np.array([-t[1], t[0]])
    return p, t, n


def build_drops(route: Route, seed: int = 11) -> RouteDrops:
    """Cone-wall style for the first four routes, prop clusters otherwise —
    mirrors the reference's placement rules (routes/README.md:553-568):
    obstacles sit ON the outbound path with a >= 2 m bypass on one side."""
    # zlib.crc32, NOT hash(): str hashing is randomized per process
    # (PYTHONHASHSEED), which made drop layouts — and every campaign table
    # built from them — unreproducible across runs
    import zlib
    rng = np.random.RandomState(
        seed * 1000 + zlib.crc32(route.name.encode()) % 1000)
    entries = []  # (x, y, r, h)
    route_no = int(route.name.split("_")[0])

    if route_no <= 4:
        # 3 cone-wall groups at 15/45/75 % of outbound + a tent at 60 %.
        for gi, frac in enumerate((0.15, 0.45, 0.75)):
            p, t, n = _path_frame(route, frac)
            side = 1.0 if gi % 2 == 0 else -1.0
            n_cones = 3 + (gi % 2)
            # wall starts 1 m to one side of the path and extends across it,
            # leaving the other side open as the bypass
            for k in range(n_cones):
                q = p + n * side * (1.0 - k * 1.0)
                entries.append((q[0], q[1], CONE_R, CONE_H))
        p, _, n = _path_frame(route, 0.6)
        entries.append((p[0], p[1], TENT_R, TENT_H))
    else:
        # 5-9 props scattered on the outbound path
        n_props = int(rng.randint(5, 10))
        fracs = np.linspace(0.12, 0.88, n_props)
        for frac in fracs:
            p, t, n = _path_frame(route, float(frac))
            kind = PROP_KINDS[int(rng.randint(len(PROP_KINDS)))]
            r, h = PROP_GEOM[kind]
            jitter = n * float(rng.uniform(-0.5, 0.5))
            entries.append((p[0] + jitter[0], p[1] + jitter[1], r, h))

    xy = np.zeros((DROP_CAP, 2), np.float32)
    radius = np.zeros(DROP_CAP, np.float32)
    height = np.zeros(DROP_CAP, np.float32)
    valid = np.zeros(DROP_CAP, bool)
    for i, (x, y, r, h) in enumerate(entries[:DROP_CAP]):
        xy[i] = (x, y)
        radius[i] = r
        height[i] = h
        valid[i] = True
    return RouteDrops(xy, radius, height, valid)


def no_drops() -> RouteDrops:
    return RouteDrops(
        np.zeros((DROP_CAP, 2), np.float32),
        np.zeros(DROP_CAP, np.float32),
        np.zeros(DROP_CAP, np.float32),
        np.zeros(DROP_CAP, bool),
    )
