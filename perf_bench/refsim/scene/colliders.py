"""Procedural forest scene -> packed collider arrays
(``nclt_slam_tpu/scene/colliders.py``).

The walled forest scene is scattered procedurally with a fixed seed and
compiled to fixed-size arrays that the depth raycaster and the route
generator consume directly:

    SceneColliders(xy (N,2), radius (N,), height (N,), kind (N,), valid (N,))

Everything is padded to ``CAPACITY``.  The generator is host numpy, a copy
of the JAX package's, draw for draw from the same ``RandomState`` streams in
the same order, so that the scene comes out bit-equal to the JAX package's.
``default_scene`` reads the port's own cache (``scene/data/scene_seed*.npz``)
and, on a miss, builds the base scene, walls its 15 base routes and saves
the result there.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np

from refsim.scene.terrain import ROAD_WPS

CAPACITY = 1536

# kind ids
KIND_TREE = 0
KIND_SHRUB = 1
KIND_ROCK = 2
KIND_ROADSIDE_TREE = 3
KIND_HOUSE = 4
KIND_BARREL = 5
KIND_DROP = 6          # runtime-dropped repeat obstacles (cones/props/tent)

# (radius, visual height) per kind — cylinders for raycasting
KIND_GEOM = {
    KIND_TREE: (0.7, 9.0),
    KIND_SHRUB: (0.4, 0.9),
    KIND_ROCK: (0.8, 0.7),
    KIND_ROADSIDE_TREE: (0.4, 7.0),
    KIND_HOUSE: (4.5, 5.5),
    KIND_BARREL: (0.5, 0.9),
}

# Scene extent (same working area as the reference forest)
X_MIN, X_MAX = -105.0, 80.0
Y_MIN, Y_MAX = -50.0, 45.0

# Corner anchors used by routes 04-09; keep them clear when scattering.
CORNERS = [(-90.0, 35.0), (65.0, 35.0), (-90.0, -35.0), (65.0, -35.0)]

HOUSES = [(-5.0, -12.0), (55.0, -14.0), (74.0, 10.0), (-60.0, 20.0),
          (25.0, 25.0), (-80.0, -20.0)]


class SceneColliders(NamedTuple):
    xy: np.ndarray       # (CAPACITY, 2) float32
    radius: np.ndarray   # (CAPACITY,) float32
    height: np.ndarray   # (CAPACITY,) float32
    kind: np.ndarray     # (CAPACITY,) int32
    valid: np.ndarray    # (CAPACITY,) bool

    @property
    def count(self) -> int:
        return int(self.valid.sum())


def _road_dist(x, y):
    """Distance from (x, y) to the road polyline (numpy, build-time only)."""
    p = np.array([x, y])
    a = ROAD_WPS[:-1]
    b = ROAD_WPS[1:]
    ab = b - a
    t = np.clip(((p - a) * ab).sum(-1) / (ab * ab).sum(-1), 0.0, 1.0)
    proj = a + t[:, None] * ab
    return float(np.sqrt(((p - proj) ** 2).sum(-1)).min())


def _corridor_polylines():
    """Carve-out corridors that must stay plannable at 2.4 m inflation: the
    road S-curve, its ±offset verges (routes 02/03), and straight segments
    between every route's spawn/turnaround anchor (routes 04-15).  The
    reference reached the same end by hand-thinning TreeCollision prims."""
    road = ROAD_WPS.astype(np.float64)
    lines = [road, road + np.array([0.0, 26.0]), road + np.array([0.0, -20.0])]
    # routes 01-03 spawn/turnaround points: connect each to the road system
    for pt in [(-80.0, -1.4), (70.5, -2.7), (-84.4, 4.5), (70.4, -2.3),
               (-94.9, -6.0), (69.7, -5.1)]:
        nearest_x = float(np.clip(pt[0], road[0, 0], road[-1, 0]))
        road_pt = (nearest_x, float(np.interp(nearest_x, road[:, 0], road[:, 1])))
        lines.append(np.array([pt, road_pt], np.float64))
        lines.append(np.array([pt, (pt[0], road_pt[1] + 26.0)], np.float64))
    # routes 04-15: carve ONLY the actual spawn->turnaround segments (an
    # all-pairs anchor mesh strips the forest so bare along the corridors
    # that the visual pipeline has nothing left to observe)
    route_pairs = [
        ((-90.0, 35.0), (65.0, -35.0)), ((65.0, 35.0), (-90.0, -35.0)),
        ((-90.0, 35.0), (65.0, 35.0)), ((65.0, -35.0), (-90.0, -35.0)),
        ((-90.0, 35.0), (-90.0, -35.0)), ((65.0, -35.0), (65.0, 35.0)),
        ((-20.0, 30.0), (24.75, -31.69)), ((-90.0, 35.0), (-24.32, -12.61)),
        ((65.0, 35.0), (-20.9, -1.84)), ((-30.0, 20.0), (27.42, -15.53)),
        ((65.0, -35.0), (-0.47, 17.48)), ((-61.5, 8.5), (25.5, -31.55)),
    ]
    for a, b in route_pairs:
        lines.append(np.array([a, b], np.float64))
    return lines


def _dist_to_polyline(pts, line):
    """Min distance from each point in pts (N,2) to polyline line (M,2)."""
    a = line[:-1][None]          # (1, M-1, 2)
    b = line[1:][None]
    p = pts[:, None, :]          # (N, 1, 2)
    ab = b - a
    denom = (ab * ab).sum(-1) + 1e-12
    t = np.clip(((p - a) * ab).sum(-1) / denom, 0.0, 1.0)
    proj = a + t[..., None] * ab
    return np.sqrt(((p - proj) ** 2).sum(-1)).min(-1)


def build_scene(seed: int = 7) -> SceneColliders:
    """Scatter a forest with the reference's composition and placement rules:
    vegetation avoids the road corridor and the corner anchors; shrubs grow
    in clumps; corridors between route anchors are kept clear of vegetation
    so every route remains plannable at 2.4 m inflation (the reference
    post-thinned TreeCollision for the same reason)."""
    rng = np.random.RandomState(seed)
    entries = []  # (x, y, r, h, kind)

    corridors = _corridor_polylines()

    def corridor_dist(x, y):
        p = np.array([[x, y]], np.float64)
        return min(float(_dist_to_polyline(p, ln)[0]) for ln in corridors)

    def clear_of_anchors(x, y, r, margin=4.0):
        return all((x - cx) ** 2 + (y - cy) ** 2 > (r + margin) ** 2
                   for cx, cy in CORNERS)

    def clear_of_existing(x, y, r, margin=1.0):
        for ex, ey, er, _, _ in entries:
            if (x - ex) ** 2 + (y - ey) ** 2 < (r + er + margin) ** 2:
                return False
        return True

    for hx, hy in HOUSES:
        r, h = KIND_GEOM[KIND_HOUSE]
        entries.append((hx, hy, r, h, KIND_HOUSE))

    # vegetation must leave (2.4 m inflation + slack) around every corridor
    # so the A* generator finds the same channels as the calibrated routes;
    # the tree-dense edges the reference has along its REAL paths are added
    # afterwards by add_route_walls (see default_scene)
    CORRIDOR_CLEAR = 3.2

    def placeable(x, y, r, road_min, margin):
        if not (X_MIN + 3 < x < X_MAX - 3 and Y_MIN + 3 < y < Y_MAX - 3):
            return False
        if _road_dist(x, y) < road_min + r:
            return False
        if corridor_dist(x, y) < CORRIDOR_CLEAR + r:
            return False
        if not clear_of_anchors(x, y, r):
            return False
        return clear_of_existing(x, y, r, margin)

    def scatter(n, kind, road_min, margin=1.0, clump=0, max_tries=60):
        r, h = KIND_GEOM[kind]
        placed = 0
        tries = 0
        while placed < n and tries < n * max_tries:
            tries += 1
            x = rng.uniform(X_MIN + 3, X_MAX - 3)
            y = rng.uniform(Y_MIN + 3, Y_MAX - 3)
            if not placeable(x, y, r, road_min, margin):
                continue
            entries.append((x, y, r, h, kind))
            placed += 1
            # clumped growth: satellites tight around the seed plant
            for _ in range(clump and int(rng.randint(0, clump))):
                if placed >= n:
                    break
                ang = rng.uniform(0, 2 * np.pi)
                d = rng.uniform(0.8, 1.8)
                sx, sy = x + d * np.cos(ang), y + d * np.sin(ang)
                if placeable(sx, sy, r, road_min, margin=-2.0 * r):
                    entries.append((sx, sy, r, h, kind))
                    placed += 1
        return placed

    scatter(130, KIND_TREE, road_min=4.0, margin=3.0, clump=2)
    scatter(28, KIND_ROCK, road_min=3.0, margin=2.0)
    scatter(297, KIND_SHRUB, road_min=2.5, margin=0.5, clump=4)
    scatter(4, KIND_BARREL, road_min=2.0, margin=2.0)

    # Verge rocks: small feature-rich litter just OUTSIDE the corridor
    # clearance (r 0.25 -> inflated 2.65 m < placement distance), so the
    # visual pipeline always has nearby texture without hurting
    # plannability.  The reference forest has ground litter everywhere;
    # the corridor carve above would otherwise leave feature deserts.
    n_verge = 120
    placed = 0
    tries = 0
    r_v, h_v = 0.25, 0.45
    while placed < n_verge and tries < n_verge * 60:
        tries += 1
        ln = corridors[int(rng.randint(len(corridors)))]
        seg = int(rng.randint(len(ln) - 1))
        t = rng.uniform()
        p = ln[seg] * (1 - t) + ln[seg + 1] * t
        tang = ln[seg + 1] - ln[seg]
        nrm = np.array([-tang[1], tang[0]])
        nrm = nrm / (np.linalg.norm(nrm) + 1e-9)
        q = p + nrm * rng.uniform(2.9, 4.5) * rng.choice([-1.0, 1.0])
        x, y = float(q[0]), float(q[1])
        if not (X_MIN + 3 < x < X_MAX - 3 and Y_MIN + 3 < y < Y_MAX - 3):
            continue
        if corridor_dist(x, y) < 2.9:
            continue
        if not clear_of_existing(x, y, r_v, margin=0.5):
            continue
        entries.append((x, y, r_v, h_v, KIND_ROCK))
        placed += 1

    # Roadside trees: deliberately near the road edge (visual landmarks for
    # the VIO along routes 01-03), alternating sides; still subject to the
    # corridor clearance so they can't block a spawn connector.
    r, h = KIND_GEOM[KIND_ROADSIDE_TREE]
    for i, x in enumerate(np.linspace(-85.0, 65.0, 7)):
        side = 1.0 if i % 2 == 0 else -1.0
        yr = float(np.interp(x, ROAD_WPS[:, 0], ROAD_WPS[:, 1])) + side * 5.5
        if corridor_dist(float(x), yr) >= CORRIDOR_CLEAR + r:
            entries.append((float(x), yr, r, h, KIND_ROADSIDE_TREE))

    n = len(entries)
    assert n <= CAPACITY, f"scene overflow: {n} > {CAPACITY}"
    xy = np.zeros((CAPACITY, 2), np.float32)
    radius = np.zeros(CAPACITY, np.float32)
    height = np.zeros(CAPACITY, np.float32)
    kind = np.zeros(CAPACITY, np.int32)
    valid = np.zeros(CAPACITY, bool)
    for i, (x, y, rr, hh, kk) in enumerate(entries):
        xy[i] = (x, y)
        radius[i] = rr
        height[i] = hh
        kind[i] = kk
        valid[i] = True
    return SceneColliders(xy, radius, height, kind, valid)


def add_route_walls(base: SceneColliders, paths, seed: int = 7,
                    spacing: float = 4.0, clear: float = 2.8) -> SceneColliders:
    """Line the GENERATED route paths with trees at the plannability limit.

    The reference forest (~1500 assets over 240x160 m) is dense right up to
    the 2.4 m inflation its route generator plans at — which is why 2-6 m of
    lateral localization error physically puts the robot among trees and
    "recovery behaviors (spin/backup/drive_on_heading) loop endlessly in
    tree-dense costmap inflation" (routes/README.md:179-185).  Our scatter
    density leaves ~8 m gaps a drifting robot slaloms through, so plant an
    explicit ragged tree line ~``clear`` m off each side of every route's
    driven polyline.  Walls are placed AFTER route generation (against the
    base scene) so the calibrated route geometry is unchanged; every wall
    tree keeps ``clear`` m of edge distance from ALL route paths, the road,
    and the corner anchors, so teach drives (GT localization) stay
    collision-free and every route remains exactly as plannable as before.

    ``paths``: list of (N, 2) dense route polylines (outbound + return).
    """
    rng = np.random.RandomState(seed * 7919 + 13)
    r_t, h_t = KIND_GEOM[KIND_TREE]

    # all path segments, concatenated, for vectorized min-distance checks
    segs_a = np.concatenate([p[:-1] for p in paths], 0).astype(np.float64)
    segs_b = np.concatenate([p[1:] for p in paths], 0).astype(np.float64)
    ab = segs_b - segs_a
    denom = (ab * ab).sum(-1) + 1e-12

    def path_dist(q):
        t = np.clip(((q[None] - segs_a) * ab).sum(-1) / denom, 0.0, 1.0)
        proj = segs_a + t[:, None] * ab
        return float(np.sqrt(((q[None] - proj) ** 2).sum(-1)).min())

    n0 = int(base.valid.sum())
    xy = base.xy.copy(); radius = base.radius.copy()
    height = base.height.copy(); kind = base.kind.copy()
    valid = base.valid.copy()
    occ_xy = [tuple(p) for p in xy[:n0]]
    occ_r = list(radius[:n0])
    n = n0

    for path in paths:
        seg_len = np.linalg.norm(np.diff(path, axis=0), axis=1)
        cum = np.concatenate([[0.0], np.cumsum(seg_len)])
        for s in np.arange(2.0, float(cum[-1]), spacing):
            seg = min(int(np.searchsorted(cum, s, side="right") - 1),
                      len(path) - 2)
            t = (s - cum[seg]) / max(seg_len[seg], 1e-9)
            p = path[seg] * (1 - t) + path[seg + 1] * t
            tang = path[seg + 1] - path[seg]
            nrm = np.array([-tang[1], tang[0]])
            nrm = nrm / (np.linalg.norm(nrm) + 1e-9)
            for side in (1.0, -1.0):
                if rng.rand() > 0.85:        # ragged line, not a fence
                    continue
                for _ in range(3):
                    off = clear + r_t + rng.uniform(0.05, 1.4)
                    q = p + nrm * side * off + rng.normal(0, 0.3, 2)
                    x, y = float(q[0]), float(q[1])
                    if not (X_MIN + 3 < x < X_MAX - 3
                            and Y_MIN + 3 < y < Y_MAX - 3):
                        continue
                    if path_dist(q) < clear + r_t:   # another route's path
                        continue
                    if _road_dist(x, y) < 4.0 + r_t:
                        continue
                    if any((x - cx) ** 2 + (y - cy) ** 2 < (r_t + 4.0) ** 2
                           for cx, cy in CORNERS):
                        continue
                    d2 = [(x - ex) ** 2 + (y - ey) ** 2 <
                          (r_t + er + 0.2) ** 2
                          for (ex, ey), er in zip(occ_xy, occ_r)]
                    if any(d2):
                        continue
                    if n >= CAPACITY:
                        break
                    xy[n] = (x, y); radius[n] = r_t; height[n] = h_t
                    kind[n] = KIND_TREE; valid[n] = True
                    occ_xy.append((x, y)); occ_r.append(r_t)
                    n += 1
                    break
    return SceneColliders(xy, radius, height, kind, valid)


_scene_cache: dict[int, SceneColliders] = {}
# the raw scene and route files the port reads too (the benchmark hands
# both sides the same inputs)
DATA_DIR = Path(__file__).resolve().parents[3] / "nclt_slam_tpu_torch" / \
    "scene" / "data"


def default_scene(seed: int = 7) -> SceneColliders:
    """The walled scene every rollout consumer uses: base scatter + the
    route-edge tree lines of add_route_walls.  Built lazily: generate the
    base, derive all 15 routes against it (cached as package data), wall
    the paths, cache the result."""
    if seed not in _scene_cache:
        p = DATA_DIR / f"scene_seed{seed}.npz"
        if p.is_file():
            z = np.load(p)
            _scene_cache[seed] = SceneColliders(
                xy=z["xy"], radius=z["radius"], height=z["height"],
                kind=z["kind"], valid=z["valid"])
        else:
            from refsim.scene.routes import base_route_paths
            base = build_scene(seed)
            walled = add_route_walls(base, base_route_paths(base, seed), seed)
            _scene_cache[seed] = walled
            p.parent.mkdir(parents=True, exist_ok=True)
            np.savez_compressed(p, xy=walled.xy, radius=walled.radius,
                                height=walled.height, kind=walled.kind,
                                valid=walled.valid)
    return _scene_cache[seed]
