"""Route registry + offline route generator (``nclt_slam_tpu/scene/routes.py``).

Shortest paths over an inflated 0.5 m occupancy grid of the scene
colliders (a Dijkstra distance field by whole-array relaxation sweeps, then
a steepest-descent backtrace), decimation + corner rounding + 0.8 m
resampling, and a hairpin turnaround with a blended offset return leg.
Route generation is an offline build step, so it stays host numpy, a copy
of the JAX package's generator operation for operation (its float32
distance field included): the routes come out bit-equal to the JAX
package's.  Generated routes are cached as the port's package data
(``scene/data/route_<name>_seed*.npz``); ``get_route`` generates and saves
a missing one against the base (wall-free) scene.

The spawn/turnaround registry keeps the reference's per-route coordinates
so that metrics remain comparable.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

from refsim.scene.colliders import (
    DATA_DIR,
    SceneColliders,
    build_scene,
    default_scene,
)
from refsim.scene.terrain import ROAD_WPS

# Fixed capacity of a dense (0.8 m) route polyline incl. turnaround + return.
DENSE_CAP = 768

CLEARANCE = 2.0
ROBOT_R = 0.4
INFLATION = CLEARANCE + ROBOT_R
GRID_MIN = (-105.0, -50.0)
GRID_MAX = (80.0, 45.0)
GRID_RES = 0.5

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
# Routes 01-03 follow the road / its forest verges rather than A* diagonals.
ROAD_LIKE = {"01_road", "02_north_forest", "03_south"}
ROAD_OFFSET = {"01_road": 0.0, "02_north_forest": 26.0, "03_south": -20.0}


class Route(NamedTuple):
    name: str
    dense_xy: np.ndarray     # (DENSE_CAP, 2) float32 — 0.8 m waypoints, padded
    n_dense: int
    spawn: tuple             # (x, y)
    spawn_yaw: float
    turnaround: tuple        # (x, y)
    turnaround_idx: int      # dense index of the hairpin apex


# ---------------------------------------------------------------------------
# occupancy grid + shortest paths (vectorized Dijkstra field + backtrace)
# ---------------------------------------------------------------------------

def build_grid(scene: SceneColliders) -> np.ndarray:
    W = int(math.ceil((GRID_MAX[0] - GRID_MIN[0]) / GRID_RES))
    H = int(math.ceil((GRID_MAX[1] - GRID_MIN[1]) / GRID_RES))
    xs = GRID_MIN[0] + (np.arange(W) + 0.5) * GRID_RES
    ys = GRID_MIN[1] + (np.arange(H) + 0.5) * GRID_RES
    gx, gy = np.meshgrid(xs, ys)             # (H, W)
    grid = np.zeros((H, W), bool)
    for i in range(scene.xy.shape[0]):
        if not scene.valid[i]:
            continue
        ox, oy = scene.xy[i]
        rr = scene.radius[i] + INFLATION
        grid |= (gx - ox) ** 2 + (gy - oy) ** 2 <= rr * rr
    return grid


_SQRT2 = np.float32(math.sqrt(2.0))
_INF = np.float32(3.0e8)
# (drow, dcol, step cost) for the 8-neighborhood, as one structured table.
_NBR = np.array([(-1, -1, _SQRT2), (-1, 0, 1.0), (-1, 1, _SQRT2),
                 (0, -1, 1.0), (0, 1, 1.0),
                 (1, -1, _SQRT2), (1, 0, 1.0), (1, 1, _SQRT2)], np.float32)


def _world_to_cell(xy) -> np.ndarray:
    """(..., 2) world coords -> (..., 2) int (row, col) grid cells."""
    xy = np.asarray(xy, np.float64)
    col = np.floor((xy[..., 0] - GRID_MIN[0]) / GRID_RES).astype(np.int64)
    row = np.floor((xy[..., 1] - GRID_MIN[1]) / GRID_RES).astype(np.int64)
    return np.stack([row, col], axis=-1)


def _cell_to_world(rc) -> np.ndarray:
    """(..., 2) int (row, col) cells -> (..., 2) world coords (cell centres)."""
    rc = np.asarray(rc, np.float64)
    x = GRID_MIN[0] + (rc[..., 1] + 0.5) * GRID_RES
    y = GRID_MIN[1] + (rc[..., 0] + 0.5) * GRID_RES
    return np.stack([x, y], axis=-1)


def _snap_free(grid: np.ndarray, rc) -> tuple:
    """Closest free cell to rc (euclidean), fully vectorized."""
    free_r, free_c = np.nonzero(~grid)
    if free_r.size == 0:
        raise RuntimeError("occupancy grid has no free cells")
    k = np.argmin((free_r - rc[0]) ** 2 + (free_c - rc[1]) ** 2)
    return (int(free_r[k]), int(free_c[k]))


def _shifted(field: np.ndarray, dr: int, dc: int, fill: np.float32) -> np.ndarray:
    """field translated by (dr, dc) with `fill` entering at the edges, so
    out[r, c] = field[r - dr, c - dc]."""
    out = np.full_like(field, fill)
    H, W = field.shape
    rs_d, rs_s = (dr, 0) if dr >= 0 else (0, -dr)
    cs_d, cs_s = (dc, 0) if dc >= 0 else (0, -dc)
    out[rs_d:H - rs_s, cs_d:W - cs_s] = field[rs_s:H - rs_d, cs_s:W - cs_d]
    return out


def distance_field(grid: np.ndarray, goal_rc) -> np.ndarray:
    """Exact 8-connected shortest-path cost-to-goal over the free space,
    computed by whole-array Bellman relaxation sweeps (the numpy twin of
    ops/wavefront_pallas.py).  Obstacle cells stay at +inf."""
    dist = np.full(grid.shape, _INF, np.float32)
    dist[goal_rc] = 0.0
    blocked = grid
    for _ in range(grid.shape[0] * grid.shape[1]):  # converges in O(path len)
        relaxed = dist
        for dr, dc, w in _NBR:
            relaxed = np.minimum(relaxed,
                                 _shifted(dist, int(dr), int(dc), _INF) + w)
        relaxed = np.where(blocked, _INF, relaxed)
        if np.array_equal(relaxed, dist):
            break
        dist = relaxed
    return dist


def trace_descent(dist: np.ndarray, start_rc) -> np.ndarray:
    """Steepest-descent walk over a distance field from start to its minimum
    (the goal).  Returns the (N, 2) cell path including both endpoints."""
    H, W = dist.shape
    offs = _NBR[:, :2].astype(np.int64)           # (8, 2)
    costs = _NBR[:, 2]
    rc = np.asarray(start_rc, np.int64)
    path = [rc]
    for _ in range(4 * (H + W)):
        if dist[tuple(rc)] <= 0.0:
            break
        cand = rc[None, :] + offs                 # (8, 2)
        ok = ((cand[:, 0] >= 0) & (cand[:, 0] < H)
              & (cand[:, 1] >= 0) & (cand[:, 1] < W))
        cand = np.where(ok[:, None], cand, 0)
        # descend along (neighbor dist + edge cost), invalid lanes masked out
        total = np.where(ok, dist[cand[:, 0], cand[:, 1]] + costs, _INF)
        k = int(np.argmin(total))
        if total[k] >= _INF:
            raise RuntimeError("trace_descent: start disconnected from goal")
        rc = cand[k]
        path.append(rc)
    return np.stack(path)


def shortest_path(grid: np.ndarray, start, goal) -> np.ndarray:
    """(N, 2) world-frame shortest path start -> goal over the free space."""
    s = _snap_free(grid, _world_to_cell(start))
    g = _snap_free(grid, _world_to_cell(goal))
    dist = distance_field(grid, g)
    if dist[s] >= _INF:
        raise RuntimeError(f"shortest_path: no path {start} -> {goal}")
    return _cell_to_world(trace_descent(dist, s))


# ---------------------------------------------------------------------------
# smoothing pipeline — every stage is an (N, 2) array -> (M, 2) array map
# ---------------------------------------------------------------------------

def decimate(pts: np.ndarray, step: float = 3.5) -> np.ndarray:
    """Keep points at >= step arc-length spacing (plus both endpoints).
    Arc length along a dense grid path tracks chord length closely, so this
    matches the classic greedy euclidean thinning on our inputs while being
    a single searchsorted."""
    pts = np.asarray(pts, np.float64)
    s = np.concatenate([[0.0], np.cumsum(np.hypot(*np.diff(pts, axis=0).T))])
    marks = np.arange(0.0, s[-1], step)
    keep = np.unique(np.searchsorted(s, marks, side="left"))
    if keep[-1] != len(pts) - 1:
        keep = np.append(keep, len(pts) - 1)
    return pts[keep]


def round_corners(pts: np.ndarray, iters: int = 2) -> np.ndarray:
    """Corner-cutting subdivision (Chaikin weights, endpoints pinned): each
    segment is replaced by its 1/4 and 3/4 points, computed by interleaved
    array blends.  The curve stays inside the control polygon's convex
    corners, so grid-path clearance is never violated."""
    pts = np.asarray(pts, np.float64)
    for _ in range(iters):
        a, b = pts[:-1], pts[1:]
        cut = np.empty((2 * len(a), 2), np.float64)
        cut[0::2] = a + 0.25 * (b - a)
        cut[1::2] = a + 0.75 * (b - a)
        pts = np.concatenate([pts[:1], cut, pts[-1:]], axis=0)
    return pts


def resample(pts: np.ndarray, ds: float = 0.8) -> np.ndarray:
    """Uniform arc-length resampling at spacing ds (endpoints preserved)."""
    pts = np.asarray(pts, np.float64)
    s = np.concatenate([[0.0], np.cumsum(np.hypot(*np.diff(pts, axis=0).T))])
    u = np.linspace(0.0, s[-1], max(int(s[-1] / ds) + 1, 2))
    return np.stack([np.interp(u, s, pts[:, 0]), np.interp(u, s, pts[:, 1])], 1)


def _packed_obstacles(scene: SceneColliders) -> tuple[np.ndarray, np.ndarray]:
    m = scene.valid
    return scene.xy[m].astype(np.float64), scene.radius[m].astype(np.float64)


def hairpin_return(outbound: np.ndarray, oxy: np.ndarray, orad: np.ndarray,
                   r0: float = 1.5, n_arc: int = 18, blend: int = 10) -> np.ndarray:
    """Append a hairpin turnaround + return leg to an outbound polyline.

    All candidate arcs — both turn directions × a shrinking radius ladder —
    are generated as one (2, R, n_arc, 2) batch and scored against every
    scene collider in a single distance computation.  Per direction the
    largest radius with >= 1.4 m clearance wins; between directions the
    higher clearance wins (capability of generate_routes.py's turnaround;
    selection implemented as masked argmax rather than search loops).
    The return leg starts offset by the turn diameter and blends linearly
    back onto the reversed outbound line; if no arc clears, the route simply
    retraces itself.
    """
    outbound = np.asarray(outbound, np.float64)
    tip, back = outbound[-1], outbound[-3]
    t = (tip - back) / (np.linalg.norm(tip - back) + 1e-9)
    left = np.array([-t[1], t[0]])

    sides = np.array([1.0, -1.0])                       # (2,)
    radii = r0 * np.array([1.0, 0.85, 0.70, 0.55])       # (R,)
    normals = sides[:, None] * left[None, :]             # (2, 2)
    centers = tip[None, None, None, :] + (normals[:, None, :] * radii[None, :, None])[:, :, None, :]  # (2,R,1,2)
    a0 = np.arctan2(tip[1] - centers[..., 1], tip[0] - centers[..., 0])  # (2,R,1)
    sweep = np.linspace(0.0, math.pi, n_arc)             # (n,)
    ang = a0 + sweep[None, None, :] * sides[:, None, None]
    arcs = centers + radii[None, :, None, None] * np.stack(
        [np.cos(ang), np.sin(ang)], axis=-1)             # (2, R, n, 2)

    gap = (np.linalg.norm(arcs[..., None, :] - oxy, axis=-1) - orad)  # (2,R,n,O)
    clear = gap.min(axis=(2, 3)) if oxy.size else np.full((2, len(radii)), np.inf)
    ok = clear >= 1.4                                    # (2, R)
    if not ok.any():
        return np.concatenate([outbound, outbound[-2::-1]], axis=0)
    # first admissible radius per side, then the side with more room
    first_r = np.where(ok.any(1), ok.argmax(1), len(radii) - 1)
    side_clear = np.where(ok.any(1), clear[np.arange(2), first_r], -np.inf)
    si = int(np.argmax(side_clear))
    ri = int(first_r[si])

    rev = outbound[-2::-1]
    w = np.clip(1.0 - np.arange(len(rev)) / blend, 0.0, None)[:, None]
    ret = rev + w * normals[si] * (2.0 * radii[ri])
    return np.concatenate([outbound, arcs[si, ri], ret], axis=0)


def _road_like_outbound(name, spawn, turnaround, grid):
    """Routes 01-03: follow the road's S-curve (offset into the forest for
    02/03) instead of a corner-to-corner diagonal.  The offset polyline is
    used as a chain of via points and each leg is planned with A* so the
    route keeps the road's shape while clearing scene colliders."""
    off = ROAD_OFFSET[name]
    x0, x1 = spawn[0], turnaround[0]
    xs = np.linspace(x0, x1, 8)
    ys = np.interp(xs, ROAD_WPS[:, 0], ROAD_WPS[:, 1]) + off
    vias = np.stack([xs, ys], axis=1)
    vias[0], vias[-1] = spawn, turnaround
    legs = [shortest_path(grid, a, b) for a, b in zip(vias[:-1], vias[1:])]
    return np.concatenate([legs[0]] + [leg[1:] for leg in legs[1:]], axis=0)


def generate_route(name: str, scene: SceneColliders | None = None,
                   grid: np.ndarray | None = None) -> Route:
    scene = scene if scene is not None else default_scene()
    meta = ROUTE_META[name]
    spawn, turnaround = meta["spawn"], meta["turnaround"]
    oxy, orad = _packed_obstacles(scene)
    if grid is None:
        grid = build_grid(scene)
    if name in ROAD_LIKE:
        raw = _road_like_outbound(name, spawn, turnaround, grid)
    else:
        raw = shortest_path(grid, spawn, turnaround)
    sm = resample(round_corners(decimate(raw, 3.5), 2), 0.8)
    full = resample(round_corners(hairpin_return(sm, oxy, orad), 1), 0.8)
    full = [tuple(p) for p in full]
    n = len(full)
    if n > DENSE_CAP:
        full = full[:DENSE_CAP]
        n = DENSE_CAP
    dense = np.zeros((DENSE_CAP, 2), np.float32)
    dense[:n] = np.asarray(full, np.float32)
    dense[n:] = dense[n - 1]  # pad with last point so masked ops stay sane
    # apex index after final resampling = closest dense point to turnaround
    d = np.hypot(dense[:n, 0] - turnaround[0], dense[:n, 1] - turnaround[1])
    apex = int(np.argmin(d))
    dxy = dense[min(5, n - 1)] - dense[0]
    spawn_yaw = float(math.atan2(dxy[1], dxy[0]))
    return Route(name=name, dense_xy=dense, n_dense=n, spawn=tuple(dense[0]),
                 spawn_yaw=spawn_yaw, turnaround=turnaround, turnaround_idx=apex)


_route_cache: dict[tuple, Route] = {}
_grid_cache: dict[int, np.ndarray] = {}

# Disk cache: generated routes of the default scene are package data, so
# runtime users just load arrays.


def _route_cache_path(name: str, seed: int):
    return DATA_DIR / f"route_{name}_seed{seed}.npz"


def _load_cached_route(name: str, seed: int) -> Route | None:
    p = _route_cache_path(name, seed)
    if not p.is_file():
        return None
    z = np.load(p)
    return Route(name=name, dense_xy=z["dense_xy"], n_dense=int(z["n_dense"]),
                 spawn=tuple(z["spawn"]), spawn_yaw=float(z["spawn_yaw"]),
                 turnaround=tuple(z["turnaround"]),
                 turnaround_idx=int(z["turnaround_idx"]))


def _save_cached_route(route: Route, seed: int):
    DATA_DIR.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        _route_cache_path(route.name, seed),
        dense_xy=route.dense_xy, n_dense=route.n_dense,
        spawn=np.asarray(route.spawn), spawn_yaw=route.spawn_yaw,
        turnaround=np.asarray(route.turnaround),
        turnaround_idx=route.turnaround_idx)


def get_route(name: str, seed: int = 7) -> Route:
    if name not in ROUTE_META:
        raise KeyError(name)
    key = (name, seed)
    if key not in _route_cache:
        cached = _load_cached_route(name, seed)
        if cached is not None:
            _route_cache[key] = cached
        else:
            # Routes are ALWAYS generated against the base (wall-free) scene:
            # default_scene adds route-edge tree walls derived from these very
            # paths (colliders.add_route_walls), so planning against it would
            # be circular — and the walls are built to keep the base-planned
            # paths exactly as clear as the generator required.
            scene = build_scene(seed)
            if seed not in _grid_cache:
                _grid_cache[seed] = build_grid(scene)
            _route_cache[key] = generate_route(name, scene, _grid_cache[seed])
            _save_cached_route(_route_cache[key], seed)
    return _route_cache[key]


def base_route_paths(base: SceneColliders, seed: int = 7):
    """Dense polylines of all 15 routes generated against the BASE scene
    (cache-backed) — the input colliders.add_route_walls lines with trees."""
    grid = None
    paths = []
    for name in ALL_ROUTES:
        key = (name, seed)
        if key not in _route_cache:
            cached = _load_cached_route(name, seed)
            if cached is not None:
                _route_cache[key] = cached
            else:
                if grid is None:
                    grid = _grid_cache.setdefault(seed, build_grid(base))
                _route_cache[key] = generate_route(name, base, grid)
                _save_cached_route(_route_cache[key], seed)
        r = _route_cache[key]
        paths.append(np.asarray(r.dense_xy[:r.n_dense], np.float64))
    return paths


def get_routes(names=None, seed: int = 7) -> list[Route]:
    return [get_route(n, seed) for n in (names or ALL_ROUTES)]
