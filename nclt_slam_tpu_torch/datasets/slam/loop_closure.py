"""Loop closure: ScanContext descriptors + 2-D pose-graph optimization
(``nclt_slam_tpu/datasets/slam/loop_closure.py``).

The polar ScanContext descriptor (60 azimuth sectors x 20 range rings) with
rotation-invariant ring-shift matching, a GPS-gated candidate search (a
dense sweep and a two-stage ring-key search for long sessions), and the
damped Gauss-Newton 2-D pose-graph optimizer (odometry weight 1, loop weight
10, first pose pinned):

- ``optimize_pose_graph``: the dense solve over the full graph;
- ``optimize_pgo``: the same Gauss-Newton on a (junction-reduced) graph with
  the TPU kernel's angle wrap and prior.  CUDA tensors go to the
  hand-written kernel (``ops/pgo.py``, ``csrc/pgo.cu``), CPU tensors to
  ``optimize_pgo_plain`` beside it;
- ``optimize_pose_graph_fast``: the km-scale path, which marginalizes the
  interior chain poses, solves the reduced graph with ``optimize_pgo`` and
  recovers the interior in closed form.

Every solver here assembles the normal equations from analytic per-edge
Jacobians, pose-major (unknown 3k + c).  The JAX package takes the dense
solve's Jacobian with ``jacfwd`` of the same residuals, to rounding.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

N_SECTORS = 60
N_RINGS = 20
MAX_RANGE = 80.0
TWO_PI = 6.283185307179586
PAIR_CHUNK = 256          # pairs of descriptors compared at once


def _hypot(x, y):
    """``jnp.hypot``'s formula, max * sqrt(1 + (min / max)^2), with
    1 + q^2 rounded once (in float64, exact before its one rounding), as
    XLA's CPU build fuses it: within two ulps of JAX's, equal in 99 % of
    cases (``torch.hypot`` differs in a third)."""
    x, y = x.abs(), y.abs()
    hi, lo = torch.maximum(x, y), torch.minimum(x, y)
    zero = hi == 0
    q = (lo / torch.where(zero, 1.0, hi)).double()
    r = hi * torch.sqrt((q * q + 1).to(x.dtype))
    r = torch.where(zero, hi, r)
    return torch.where(torch.isinf(x) | torch.isinf(y), math.inf, r)


def scan_context(pts, valid, n_sectors: int = N_SECTORS,
                 n_rings: int = N_RINGS, max_range: float = MAX_RANGE):
    """Polar max-height descriptor (..., n_rings, n_sectors) of scans
    (..., N, 3) with validity (..., N)."""
    x, y, z = pts.unbind(-1)
    rng = _hypot(x, y)
    ang = torch.atan2(y, x)  # [-pi, pi]
    ring = (rng / max_range * n_rings).to(torch.int32).clamp(0, n_rings - 1)
    sector = ((ang + math.pi) / (2 * math.pi) * n_sectors) \
        .to(torch.int32).clamp(0, n_sectors - 1)
    flat = ring * n_sectors + sector
    ok = valid & (rng < max_range)
    desc = torch.full(pts.shape[:-2] + (n_rings * n_sectors,), -math.inf,
                      dtype=pts.dtype, device=pts.device)
    desc = desc.scatter_reduce(-1, torch.where(ok, flat, 0).long(),
                               torch.where(ok, z, -math.inf), "amax")
    desc = torch.where(torch.isfinite(desc), desc, 0.0)
    return desc.reshape(pts.shape[:-2] + (n_rings, n_sectors))


def _shift_dists(d1, d2):
    """Cosine distance of d1 to every column shift of d2 (reference
    distance_rot: the flattened dot product, so empty cells contribute
    nothing).  d1, d2 (..., R, S) -> (..., S), entry s for
    ``roll(d2, s, axis=-1)``."""
    R, S = d1.shape[-2:]
    v1 = d1.reshape(d1.shape[:-2] + (R * S,))
    n1 = torch.linalg.vector_norm(v1, dim=-1)
    v1n = v1 / n1.clamp_min(1e-6)[..., None]
    ar = torch.arange(S, device=d2.device)
    shift = (ar[None, :] - ar[:, None]) % S          # [s, c] = (c - s) mod S
    rolled = d2[..., shift]                          # (..., R, S, S)
    rolled = rolled.transpose(-3, -2).reshape(d2.shape[:-2] + (S, R * S))
    n2 = torch.linalg.vector_norm(rolled, dim=-1)    # (..., S)
    dots = (rolled @ v1n[..., :, None])[..., 0] / n2.clamp_min(1e-6)
    dists = torch.where(n2 < 1e-6, 1.0, 1.0 - dots)
    return torch.where((n1 < 1e-6)[..., None], 1.0, dists)


def sc_distance(d1, d2):
    """Rotation-invariant ScanContext distance: (min over column shifts of
    the whole-descriptor cosine distance, the first shift that reaches it).
    d1, d2 (..., R, S)."""
    dists = _shift_dists(d1, d2)
    return dists.min(-1).values, dists.argmin(-1)


def _pair_dists(descs, i, j):
    """``sc_distance(descs[i], descs[j])[0]`` for index vectors i, j, in
    chunks of PAIR_CHUNK pairs."""
    out = [_shift_dists(descs[a], descs[b]).min(-1).values
           for a, b in zip(i.split(PAIR_CHUNK), j.split(PAIR_CHUNK))]
    return torch.cat(out) if out else descs.new_zeros(0)


def _candidates(positions, valid, min_gap, gps_radius):
    """(K, K) gate: i < j closer than gps_radius, more than min_gap apart,
    both valid."""
    K = positions.shape[0]
    d_pos = torch.linalg.vector_norm(positions[:, None] - positions[None, :],
                                     dim=-1)
    ar = torch.arange(K, device=positions.device)
    gap = (ar[:, None] - ar[None, :]).abs()
    cand = (d_pos < gps_radius) & (gap > min_gap) & \
        valid[:, None] & valid[None, :]
    return torch.triu(cand)


def detect_loops(descs, positions, valid, min_gap: int = 50,
                 gps_radius: float = 10.0, sc_thresh: float = 0.25,
                 max_loops: int = 32):
    """GPS-gated loop detection over a batch of descriptors.

    descs (K, R, S), positions (K, 2).  Returns fixed-size tensors
    (i_idx, j_idx, found) of up to ``max_loops`` loop pairs (best-first;
    equal distances in pair order, as JAX's stable argsort)."""
    K = descs.shape[0]
    cand = _candidates(positions, valid, min_gap, gps_radius)
    ci, cj = cand.nonzero(as_tuple=True)
    dists = torch.full((K, K), math.inf, dtype=descs.dtype,
                       device=descs.device)
    dists[ci, cj] = _pair_dists(descs, ci, cj)
    flat = dists.reshape(-1)
    order = torch.argsort(flat, stable=True)[:max_loops]
    found = torch.isfinite(flat[order]) & (flat[order] < sc_thresh)
    return order // K, order % K, found


def ring_key(desc):
    """Rotation-invariant ring key: per-ring mean occupancy (R,) — the
    ScanContext paper's first-stage search key."""
    return desc.mean(-1)


def detect_loops_scalable(descs, positions, valid, min_gap: int = 50,
                          gps_radius: float = 10.0, sc_thresh: float = 0.25,
                          max_loops: int = 32, shortlist: int = 256):
    """Two-stage loop detection for long sessions.

    Stage 1: ring-key L1 distance over all gated pairs (one (K, K, R)
    reduction).  Stage 2: the full rotation-search ScanContext distance on
    the ``shortlist`` best candidates.  Same thresholds and semantics as
    detect_loops."""
    K = descs.shape[0]
    cand = _candidates(positions, valid, min_gap, gps_radius)
    keys = ring_key(descs)                                    # (K, R)
    key_d = (keys[:, None, :] - keys[None, :, :]).abs().mean(-1)
    key_d = torch.where(cand, key_d, math.inf)

    flat = key_d.reshape(-1)
    short = torch.argsort(flat, stable=True)[:shortlist]      # best ring-keys
    si, sj = short // K, short % K
    s_ok = torch.isfinite(flat[short])

    dists = torch.where(s_ok, _pair_dists(descs, si, sj), math.inf)
    order = torch.argsort(dists, stable=True)[:max_loops]
    found = torch.isfinite(dists[order]) & (dists[order] < sc_thresh)
    return si[order], sj[order], found


class PoseGraph2D(NamedTuple):
    """Fixed-size 2-D pose graph: K poses, a chain of K-1 odometry edges and
    L loop edges."""

    poses: torch.Tensor      # (K, 3) x, y, theta
    odo_meas: torch.Tensor   # (K-1, 3) relative measurements
    loop_i: torch.Tensor     # (L,)
    loop_j: torch.Tensor     # (L,)
    loop_meas: torch.Tensor  # (L, 3)
    loop_valid: torch.Tensor  # (L,)


def _wrap_atan2(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


def _wrap_floor(a):
    """Angle wrap to [-pi, pi) without atan2, as the TPU kernel does
    (``ops/pgo_pallas.py:_wrap``); it differs from the atan2 form only at
    exactly +-pi."""
    return a - TWO_PI * torch.floor((a + 0.5 * TWO_PI) / TWO_PI)


def _rel_residual(pi, pj, meas, wrap=_wrap_atan2):
    """SE(2) relative residuals of edges pi -> pj (E, 3) against their
    measurements, with the analytic Jacobians: (r (E, 3), J_i (E, 3, 3),
    J_j (E, 3, 3)), rows (rx, ry, rt), columns (x, y, theta)."""
    c, s = torch.cos(pi[:, 2]), torch.sin(pi[:, 2])
    dx = pj[:, 0] - pi[:, 0]
    dy = pj[:, 1] - pi[:, 1]
    Rx = c * dx + s * dy
    Ry = -s * dx + c * dy
    r = torch.stack([Rx - meas[:, 0], Ry - meas[:, 1],
                     wrap(pj[:, 2] - pi[:, 2] - meas[:, 2])], -1)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    Ji = torch.stack([torch.stack([-c, -s, Ry], -1),
                      torch.stack([s, -c, -Rx], -1),
                      torch.stack([zero, zero, -one], -1)], -2)
    Jj = torch.stack([torch.stack([c, s, zero], -1),
                      torch.stack([-s, c, zero], -1),
                      torch.stack([zero, zero, one], -1)], -2)
    return r, Ji, Jj


def _normal_equations(poses, anchor, ei, ej, meas, w, prior_w, damping,
                      wrap):
    """Dense pose-major normal equations (H (3K, 3K), g (3K,)) of the
    weighted edges ei -> ej, a prior of weight prior_w pinning pose 0 at
    ``anchor`` and damping on the diagonal.

    Both are assembled with ``index_put_(accumulate=True)``, which on CUDA
    sorts the indices (stably) and sums each index's values in that order,
    without atomics: two runs give the same bits.  ``index_add_`` adds with
    float atomics there, in an order that changes from run to run."""
    K = poses.shape[0]
    N = 3 * K
    r, Ji, Jj = _rel_residual(poses[ei], poses[ej], meas, wrap)
    w3 = w[:, None, None]
    Hii = w3 * Ji.transpose(1, 2) @ Ji
    Hij = w3 * Ji.transpose(1, 2) @ Jj
    Hjj = w3 * Jj.transpose(1, 2) @ Jj
    blocks = torch.cat([Hii, Hij, Hij.transpose(1, 2), Hjj])
    bi = torch.cat([ei, ei, ej, ej])
    bj = torch.cat([ei, ej, ei, ej])
    c3 = torch.arange(3, device=poses.device)
    rows = (3 * bi)[:, None, None] + c3[None, :, None]
    cols = (3 * bj)[:, None, None] + c3[None, None, :]
    H = poses.new_zeros(N, N).index_put_(
        (rows.expand_as(blocks).reshape(-1), cols.expand_as(blocks)
         .reshape(-1)), blocks.reshape(-1), accumulate=True)
    gi = (w3 * Ji.transpose(1, 2) @ r[..., None])[..., 0]
    gj = (w3 * Jj.transpose(1, 2) @ r[..., None])[..., 0]
    grows = 3 * torch.cat([ei, ej])[:, None] + c3
    g = poses.new_zeros(N).index_put_((grows.reshape(-1),),
                                      torch.cat([gi, gj]).reshape(-1),
                                      accumulate=True)
    diag = torch.full((N,), damping, dtype=poses.dtype, device=poses.device)
    diag[:3] += prior_w
    g[:3] += prior_w * (poses[0] - anchor)
    return H + torch.diag(diag), g


def _edges(graph: PoseGraph2D, odo_w, lc_w):
    """The chain and the loop edges of ``graph`` as one list: (ei, ej, meas,
    w), loop indices clamped to [0, K-1] and loop weights lc_w * valid."""
    poses = graph.poses
    K = poses.shape[0]
    dev, dt = poses.device, poses.dtype
    chain = torch.arange(K - 1, device=dev)
    w_odo = torch.as_tensor(odo_w, dtype=dt, device=dev).expand(K - 1)
    li = graph.loop_i.long().clamp(0, K - 1)
    lj = graph.loop_j.long().clamp(0, K - 1)
    w_lc = lc_w * graph.loop_valid.to(dt)
    return (torch.cat([chain, li]), torch.cat([chain + 1, lj]),
            torch.cat([graph.odo_meas.to(dt), graph.loop_meas.to(dt)]),
            torch.cat([w_odo, w_lc]))


def _gauss_newton(graph: PoseGraph2D, odo_w, iters, lc_w, damping,
                  prior_w, wrap):
    ei, ej, meas, w = _edges(graph, odo_w, lc_w)
    anchor = graph.poses[0]
    x = graph.poses
    for _ in range(iters):
        H, g = _normal_equations(x, anchor, ei, ej, meas, w, prior_w,
                                 damping, wrap)
        x = x - torch.linalg.solve(H, g).reshape(-1, 3)
    return x


def optimize_pose_graph(graph: PoseGraph2D, iters: int = 20,
                        odo_w=1.0, lc_w: float = 10.0,
                        damping: float = 1e-3) -> torch.Tensor:
    """Damped GN over the full 2-D pose graph (odom_w=1, lc_w=10, first pose
    pinned by a prior of weight 100^2).  Returns optimized poses (K, 3).

    ``odo_w`` may be a scalar or a per-edge (K-1,) tensor (the reduced graph
    from reduce_pose_graph carries composed-segment weights).  Dense
    (3K x 3K) normal equations: for km-scale sessions use
    optimize_pose_graph_fast."""
    return _gauss_newton(graph, odo_w, iters, lc_w, damping, 1e4,
                         _wrap_atan2)


# ---------------------------------------------------------------------------
# the reduced-graph solver: kernel K4 and its plain version
# ---------------------------------------------------------------------------

def _check_graph(graph: PoseGraph2D, odo_w):
    K = graph.poses.shape[0]
    L = graph.loop_i.shape[0]
    shapes = dict(poses=(K, 3), odo_meas=(K - 1, 3), loop_i=(L,),
                  loop_j=(L,), loop_meas=(L, 3), loop_valid=(L,))
    if graph.poses.dim() != 2 or K < 2:
        raise ValueError("optimize_pgo takes a graph of at least two poses "
                         f"(K, 3); got {tuple(graph.poses.shape)}")
    for name, shape in shapes.items():
        t = getattr(graph, name)
        if tuple(t.shape) != shape:
            raise ValueError(f"optimize_pgo: {name} is {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.device != graph.poses.device:
            raise ValueError("optimize_pgo: inputs on different devices")
    if torch.is_tensor(odo_w) and odo_w.dim() and \
            tuple(odo_w.shape) != (K - 1,):
        raise ValueError(f"optimize_pgo: odo_w is {tuple(odo_w.shape)}, "
                         f"expected a scalar or ({K - 1},)")


def optimize_pgo_plain(graph: PoseGraph2D, odo_w, iters: int = 15,
                       lc_w: float = 10.0, damping: float = 1e-3,
                       prior_w: float = 1e4) -> torch.Tensor:
    """K4's function in plain PyTorch, in the dtype of ``graph.poses``:
    ``iters`` damped Gauss-Newton steps on the graph with chain weights
    ``odo_w``, loop weights ``lc_w * valid``, a prior of weight ``prior_w``
    pinning pose 0 and the floor-form angle wrap, each step a dense solve.
    Returns the optimized poses (K, 3)."""
    _check_graph(graph, odo_w)
    return _gauss_newton(graph, odo_w, iters, lc_w, damping, prior_w,
                         _wrap_floor)


def optimize_pgo(graph: PoseGraph2D, odo_w, iters: int = 15,
                 lc_w: float = 10.0, damping: float = 1e-3,
                 prior_w: float = 1e4, site: str = "other") -> torch.Tensor:
    """Solve a (reduced) PoseGraph2D: the JAX package's
    ``ops/pgo_pallas.py:optimize_pgo_pallas`` without its lane padding.
    CUDA tensors go to the hand-written kernel (one launch, counted under
    ``site``), CPU tensors to ``optimize_pgo_plain``."""
    dev = graph.poses.device
    if dev.type == "cuda":
        from nclt_slam_tpu_torch.ops.pgo import optimize_pgo_cuda
        _check_graph(graph, odo_w)
        return optimize_pgo_cuda(graph, odo_w, iters=iters, lc_w=lc_w,
                                 damping=damping, prior_w=prior_w, site=site)
    if dev.type == "cpu":
        return optimize_pgo_plain(graph, odo_w, iters=iters, lc_w=lc_w,
                                  damping=damping, prior_w=prior_w)
    raise ValueError(f"optimize_pgo: unsupported device {dev}")


# ---------------------------------------------------------------------------
# km-scale PGO: junction reduction + closed-form interior recovery
# ---------------------------------------------------------------------------
#
# Only the loop-edge endpoints (plus the two chain ends) are coupled: every
# interior chain pose hangs off its segment by odometry factors alone, so it
# is marginalized into one composed relative factor between its segment's
# endpoints and recovered afterwards by distributing the endpoint
# discrepancy along the segment.  The reduced problem has Kr <= 2 + 2L poses.


def _odo_chain(poses, odo):
    """Vectorized open-loop chain from pose 0 through all odometry edges:
    G[k] = T(poses[0]) o m_0 o ... o m_{k-1}  (numpy, (K, 3))."""
    th = np.concatenate([[poses[0, 2]],
                         poses[0, 2] + np.cumsum(odo[:, 2])])
    c, s = np.cos(th[:-1]), np.sin(th[:-1])
    steps = np.stack([c * odo[:, 0] - s * odo[:, 1],
                      s * odo[:, 0] + c * odo[:, 1]], -1)
    xy = np.concatenate([poses[0:1, :2],
                         poses[0, :2] + np.cumsum(steps, axis=0)])
    return np.column_stack([xy, th]).astype(np.float32)


def _numpy(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def reduce_pose_graph(graph: PoseGraph2D, odo_w: float = 1.0):
    """Marginalize interior chain poses (host-side numpy, vectorized
    through the global odometry chain).

    Returns (reduced PoseGraph2D on the graph's device, odo_w_reduced
    (Kr-1,), junctions (Kr,) numpy).  Composed segment weight = odo_w /
    n_edges (the isotropic approximation the reference's optimizer makes
    for its own factors)."""
    dev = graph.poses.device
    poses = _numpy(graph.poses)
    odo = _numpy(graph.odo_meas)
    li = _numpy(graph.loop_i)
    lj = _numpy(graph.loop_j)
    valid = _numpy(graph.loop_valid).astype(bool)
    K = len(poses)

    ends = np.concatenate([[0, K - 1], li[valid], lj[valid]])
    junctions = np.unique(ends.astype(np.int64))
    Kr = len(junctions)

    G = _odo_chain(poses, odo)
    a, b = junctions[:-1], junctions[1:]
    if Kr > 1:
        dth = G[b, 2] - G[a, 2]
        ca, sa = np.cos(G[a, 2]), np.sin(G[a, 2])
        dx, dy = G[b, 0] - G[a, 0], G[b, 1] - G[a, 1]
        red_odo = np.stack([ca * dx + sa * dy, -sa * dx + ca * dy,
                            dth], -1).astype(np.float32)
        red_w = (odo_w / np.maximum(b - a, 1)).astype(np.float32)
    else:
        red_odo = np.zeros((1, 3), np.float32)
        red_w = np.ones(1, np.float32)

    red_li = np.searchsorted(junctions, np.clip(li, 0, K - 1)).astype(np.int32)
    red_lj = np.searchsorted(junctions, np.clip(lj, 0, K - 1)).astype(np.int32)
    red_li = np.clip(red_li, 0, Kr - 1)
    red_lj = np.clip(red_lj, 0, Kr - 1)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    reduced = PoseGraph2D(poses=t(poses[junctions]), odo_meas=t(red_odo),
                          loop_i=t(red_li), loop_j=t(red_lj),
                          loop_meas=graph.loop_meas,
                          loop_valid=graph.loop_valid)
    return reduced, t(red_w), junctions


def expand_reduced(graph: PoseGraph2D, junctions, opt_red) -> np.ndarray:
    """Recover interior chain poses from optimized junction poses (numpy,
    one vectorized pass over all poses).

    Per segment [a..b]: rigid-place the raw odometry chain at the optimized
    pose of a, measure the endpoint discrepancy at b, and distribute it
    along the segment by cumulative path length — rotation interpolated
    about a, the translation residue linearly (exact at both endpoints)."""
    poses = _numpy(graph.poses)
    odo = _numpy(graph.odo_meas)
    opt_red = _numpy(opt_red)
    K = len(poses)
    G = _odo_chain(poses, odo)

    seg = np.clip(np.searchsorted(junctions, np.arange(K), side="right") - 1,
                  0, len(junctions) - 2)
    ja = junctions[seg]
    jb = junctions[seg + 1]
    pa = opt_red[seg]
    pb = opt_red[seg + 1]

    tha = G[ja, 2]
    ca, sa = np.cos(tha), np.sin(tha)
    rx = G[:, 0] - G[ja, 0]
    ry = G[:, 1] - G[ja, 1]
    rel = np.stack([ca * rx + sa * ry, -sa * rx + ca * ry], -1)
    th_rel = G[:, 2] - tha
    cp, sp = np.cos(pa[:, 2]), np.sin(pa[:, 2])
    chain_xy = pa[:, :2] + np.stack([cp * rel[:, 0] - sp * rel[:, 1],
                                     sp * rel[:, 0] + cp * rel[:, 1]], -1)
    chain_th = pa[:, 2] + th_rel

    relb = np.stack([ca * (G[jb, 0] - G[ja, 0]) + sa * (G[jb, 1] - G[ja, 1]),
                     -sa * (G[jb, 0] - G[ja, 0]) + ca * (G[jb, 1] - G[ja, 1])],
                    -1)
    chain_xy_b = pa[:, :2] + np.stack(
        [cp * relb[:, 0] - sp * relb[:, 1],
         sp * relb[:, 0] + cp * relb[:, 1]], -1)
    chain_th_b = pa[:, 2] + (G[jb, 2] - tha)
    dth = np.arctan2(np.sin(pb[:, 2] - chain_th_b),
                     np.cos(pb[:, 2] - chain_th_b))

    steps = np.concatenate([[0.0], np.hypot(odo[:, 0], odo[:, 1])])
    cum = np.cumsum(steps)
    f = (cum - cum[ja]) / np.maximum(cum[jb] - cum[ja], 1e-9)

    cf, sf = np.cos(f * dth), np.sin(f * dth)
    relp = chain_xy - pa[:, :2]
    rot = np.stack([cf * relp[:, 0] - sf * relp[:, 1],
                    sf * relp[:, 0] + cf * relp[:, 1]], -1)
    cfb, sfb = np.cos(dth), np.sin(dth)
    relb_p = chain_xy_b - pa[:, :2]
    end_rot = np.stack([cfb * relb_p[:, 0] - sfb * relb_p[:, 1],
                        sfb * relb_p[:, 0] + cfb * relb_p[:, 1]], -1)
    t_corr = pb[:, :2] - (pa[:, :2] + end_rot)

    out = np.empty((K, 3), np.float32)
    out[:, :2] = pa[:, :2] + rot + f[:, None] * t_corr
    out[:, 2] = chain_th + f * dth
    out[junctions] = opt_red
    return out


def optimize_pose_graph_fast(graph: PoseGraph2D, iters: int = 15,
                             odo_w: float = 1.0, lc_w: float = 10.0,
                             damping: float = 1e-3,
                             backend: str = "auto") -> torch.Tensor:
    """Junction-reduced PGO for km-scale sessions; returns (K, 3) poses on
    the graph's device.

    backend "fused" (the default; "auto" is the same): reduction, reduced
    solve and interior expansion as tensor code on the graph's device, with
    the junction set padded to its static bound Kr = 2 + 2L — one
    ``optimize_pgo`` call (on the card: one K4 launch).  "xla" and
    "pallas" (the JAX package's names for its two host routes): numpy
    ``reduce_pose_graph``, ``optimize_pgo`` on the unpadded reduced graph,
    numpy ``expand_reduced``."""
    if backend in ("auto", "fused"):
        return _pgo_fused(graph, odo_w, iters, lc_w, damping)
    if backend not in ("xla", "pallas"):
        raise ValueError(f"optimize_pose_graph_fast: unknown backend "
                         f"{backend!r}")
    reduced, red_w, junctions = reduce_pose_graph(graph, odo_w)
    opt_red = optimize_pgo(reduced, red_w, iters=iters, lc_w=lc_w,
                           damping=damping, site="host")
    return torch.from_numpy(expand_reduced(graph, junctions, opt_red)) \
        .to(graph.poses.device)


def _set_last(base, idx, vals):
    """``base.at[idx].set(vals)`` with XLA-CPU's order for repeated
    indices: the last row wins.  base (K, C), idx (R,), vals (R, C)."""
    rows = torch.arange(idx.shape[0], device=idx.device)
    winner = torch.full((base.shape[0],), -1, dtype=torch.int64,
                        device=idx.device)
    winner = winner.scatter_reduce(0, idx, rows, "amax")
    return torch.where((winner >= 0)[:, None], vals[winner.clamp_min(0)],
                       base)


def reduce_pose_graph_padded(graph: PoseGraph2D, odo_w=1.0):
    """The fused route's junction reduction, as tensor code on the graph's
    device: (reduced PoseGraph2D of Kr = 2 + 2L poses, red_w (Kr-1,),
    junctions (Kr,), the global odometry chain G (K, 3)).

    The junction set is the sorted unique {0, K-1, valid loop ends}, padded
    with copies of K-1, whose zero-length / zero-measurement segments
    (weight odo_w) pin the padded poses to the final pose."""
    poses, odo = graph.poses, graph.odo_meas
    K = poses.shape[0]
    dev = poses.device

    li = torch.where(graph.loop_valid, graph.loop_i.long(), K - 1)
    lj = torch.where(graph.loop_valid, graph.loop_j.long(), K - 1)
    ends = torch.sort(torch.cat(
        [torch.tensor([0, K - 1], device=dev), li, lj])).values
    dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                     ends[1:] == ends[:-1]])
    junctions = torch.sort(torch.where(dup, K - 1, ends)).values   # (Kr,)
    Kr = junctions.shape[0]

    # global odometry chain G[k] = T(poses[0]) . m_0 ... m_{k-1}
    th = torch.cat([poses[0:1, 2], poses[0, 2] + torch.cumsum(odo[:, 2], 0)])
    c, s = torch.cos(th[:-1]), torch.sin(th[:-1])
    steps = torch.stack([c * odo[:, 0] - s * odo[:, 1],
                         s * odo[:, 0] + c * odo[:, 1]], -1)
    Gxy = torch.cat([poses[0:1, :2], poses[0, :2] + torch.cumsum(steps, 0)])
    G = torch.cat([Gxy, th[:, None]], -1)

    # composed segment measurements between consecutive junctions
    a, b = junctions[:-1], junctions[1:]
    dth_seg = G[b, 2] - G[a, 2]
    ca, sa = torch.cos(G[a, 2]), torch.sin(G[a, 2])
    dxy = G[b, :2] - G[a, :2]
    red_odo = torch.stack([ca * dxy[:, 0] + sa * dxy[:, 1],
                           -sa * dxy[:, 0] + ca * dxy[:, 1], dth_seg], -1)
    red_w = odo_w / (b - a).clamp_min(1).to(poses.dtype)

    red_li = torch.searchsorted(junctions, li).clamp(0, Kr - 1)
    red_lj = torch.searchsorted(junctions, lj).clamp(0, Kr - 1)
    reduced = PoseGraph2D(poses=poses[junctions], odo_meas=red_odo,
                          loop_i=red_li, loop_j=red_lj,
                          loop_meas=graph.loop_meas,
                          loop_valid=graph.loop_valid)
    return reduced, red_w, junctions, G


def _pgo_fused(graph: PoseGraph2D, odo_w, iters, lc_w, damping):
    """Junction-reduced PGO as tensor code with no host round trip: reduce
    (``reduce_pose_graph_padded``) -> solve -> expand.  The final write of
    the junction poses names K-1 once for each padded copy: the last copy
    wins (``_set_last``), as XLA on the CPU applies the JAX package's
    ``out.at[junctions].set``."""
    poses, odo = graph.poses, graph.odo_meas
    K = poses.shape[0]
    dev = poses.device
    reduced, red_w, junctions, G = reduce_pose_graph_padded(graph, odo_w)
    Kr = junctions.shape[0]
    opt_red = optimize_pgo(reduced, red_w, iters=iters, lc_w=lc_w,
                           damping=damping, site="fused")

    # interior expansion: rigid-place each segment's raw chain at the
    # optimized start pose, distribute the endpoint discrepancy by
    # cumulative arc length (exact at both endpoints)
    seg = (torch.searchsorted(junctions, torch.arange(K, device=dev),
                              right=True) - 1).clamp(0, Kr - 2)
    ja, jb = junctions[seg], junctions[seg + 1]
    pa, pb = opt_red[seg], opt_red[seg + 1]

    tha = G[ja, 2]
    ca, sa = torch.cos(tha), torch.sin(tha)
    rx, ry = G[:, 0] - G[ja, 0], G[:, 1] - G[ja, 1]
    rel = torch.stack([ca * rx + sa * ry, -sa * rx + ca * ry], -1)
    th_rel = G[:, 2] - tha
    cp, sp = torch.cos(pa[:, 2]), torch.sin(pa[:, 2])
    chain_xy = pa[:, :2] + torch.stack(
        [cp * rel[:, 0] - sp * rel[:, 1],
         sp * rel[:, 0] + cp * rel[:, 1]], -1)
    chain_th = pa[:, 2] + th_rel

    relb = torch.stack(
        [ca * (G[jb, 0] - G[ja, 0]) + sa * (G[jb, 1] - G[ja, 1]),
         -sa * (G[jb, 0] - G[ja, 0]) + ca * (G[jb, 1] - G[ja, 1])], -1)
    chain_xy_b = pa[:, :2] + torch.stack(
        [cp * relb[:, 0] - sp * relb[:, 1],
         sp * relb[:, 0] + cp * relb[:, 1]], -1)
    chain_th_b = pa[:, 2] + (G[jb, 2] - tha)
    dth = torch.atan2(torch.sin(pb[:, 2] - chain_th_b),
                      torch.cos(pb[:, 2] - chain_th_b))

    steps_len = torch.cat([poses.new_zeros(1), _hypot(odo[:, 0], odo[:, 1])])
    cum = torch.cumsum(steps_len, 0)
    f = (cum - cum[ja]) / (cum[jb] - cum[ja]).clamp_min(1e-9)

    cf, sf = torch.cos(f * dth), torch.sin(f * dth)
    relp = chain_xy - pa[:, :2]
    rot = torch.stack([cf * relp[:, 0] - sf * relp[:, 1],
                       sf * relp[:, 0] + cf * relp[:, 1]], -1)
    cfb, sfb = torch.cos(dth), torch.sin(dth)
    relb_p = chain_xy_b - pa[:, :2]
    end_rot = torch.stack([cfb * relb_p[:, 0] - sfb * relb_p[:, 1],
                           sfb * relb_p[:, 0] + cfb * relb_p[:, 1]], -1)
    t_corr = pb[:, :2] - (pa[:, :2] + end_rot)

    out_xy = pa[:, :2] + rot + f[:, None] * t_corr
    out_th = chain_th + f * dth
    out = torch.cat([out_xy, out_th[:, None]], -1)
    return _set_last(out, junctions, opt_red)
