"""The anchor matcher's Horn solver is batch-invariant, and rounds in the
JAX package's order.

``_horn_starts`` (and with it ``_kabsch`` and ``ransac_pose``) sums every
product in a fixed order: over the points by a fixed pairwise tree, over
its 4 x 4 algebra left to right as the JAX package's unrolled Python sums
do.  So a row's result does not depend on the rows beside it:

- 15 rows alone are bit-equal to the same 15 rows first in a 60-row batch
  whose other 45 rows hold other data, for ``_horn_starts``, ``_kabsch``
  and ``ransac_pose``, on inputs made from a numpy seed and on the
  replayed matcher cases (``tests/data/torch_matcher_{case,
  tie_case}.npz``);
- ``match_tick`` the same, but within ``CPU_BATCH_ATOL`` where not
  bit-equal: it takes ``cos`` and ``sin`` of the teach yaw, and ATen's
  vectorized transcendentals round a tensor's tail otherwise on the CPU
  (``chip_smoke.py`` 11i holds the card bit for bit);
- ``_horn_starts`` is bit-equal to a numpy float32 evaluation in that
  order (``horn_np``: the JAX package's order for the 4 x 4 algebra,
  ``nclt_slam_tpu/landmarks/matcher.py:67-94``, the port's tree for the
  point sums) on the tie case's RANSAC hypotheses and on refit-sized
  point sets;
- ``tests/data/torch_horn_tie_case.npz`` (``tools/torch_horn_case.py``),
  which the card compares its bits with, is the CPU's result now.

The VIO's motion-only Gauss-Newton (``vio/tracker.py:_pose_gn``) sums its
normal equations the same way (``_normal_equations``: ``J^T W J`` and
``J^T W r`` by the pairwise tree over the 768 residual rows): 15 rows
alone are bit-equal to the same rows first in a 120-row batch, and to a
numpy float32 evaluation of the tree; the whole solve within
``CPU_BATCH_ATOL`` (it takes ``sin`` and ``cos`` in ``so3_exp``).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nclt_slam_tpu_torch import config as tcfg
from nclt_slam_tpu_torch.landmarks import matcher as tm
from nclt_slam_tpu_torch.vio import tracker as ttr
from torch_calibrate_common import CPU_BATCH_ATOL

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
import torch_horn_case  # noqa: E402

torch.set_num_threads(1)

DATA = Path(__file__).parent / "data"
CASES = {"case": DATA / "torch_matcher_case.npz",
         "tie_case": DATA / "torch_matcher_tie_case.npz"}
ROWS, BATCH = 15, 60

f32 = np.float32


# --- the numpy evaluation in the reference's order -------------------------

def tree_sum_np(x, axis):
    """``matcher._tree_sum`` in numpy (the axis kept)."""
    n = x.shape[axis]
    while n > 1:
        h = n // 2
        s = np.take(x, range(h), axis) + np.take(x, range(h, 2 * h), axis)
        x = s if n % 2 == 0 else np.concatenate(
            [s, np.take(x, [2 * h], axis)], axis)
        n = x.shape[axis]
    return x


def horn_np(P, Q, w):
    """Horn's starts in float32, one rounding an operation: the centroids
    and the cross-covariance by the port's point tree, the shift's nine
    squares row-major, the 4 x 4 algebra as the JAX package's Python grid
    and sums (each starting from its first term)."""
    P, Q, w = (np.asarray(a, f32) for a in (P, Q, w))
    w = w[..., None]
    wsum = np.maximum(tree_sum_np(w, -2), f32(1e-6))
    mp = tree_sum_np(P * w, -2) / wsum
    mq = tree_sum_np(Q * w, -2) / wsum
    X, Y = (P - mp) * w, Q - mq
    H = tree_sum_np(X[..., :, None] * Y[..., None, :], -3)[..., 0, :, :]
    sq = H * H
    acc = sq[..., 0, 0]
    for i, j in [(i, j) for i in range(3) for j in range(3)][1:]:
        acc = acc + sq[..., i, j]
    shift = f32(2.0) * np.sqrt(acc) + f32(1e-6)
    (sxx, sxy, sxz), (syx, syy, syz), (szx, szy, szz) = \
        [[H[..., i, j] for j in range(3)] for i in range(3)]
    Nm = [
        [sxx + syy + szz + shift, syz - szy, szx - sxz, sxy - syx],
        [syz - szy, sxx - syy - szz + shift, sxy + syx, szx + sxz],
        [szx - sxz, sxy + syx, -sxx + syy - szz + shift, syz + szy],
        [sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz + shift],
    ]
    one = np.ones_like(shift)
    V = [[one * f32(1.05 if i == k else 0.05) for k in range(4)]
         for i in range(4)]
    for _ in range(tm._POWER_ITERS):
        V2 = [[None] * 4 for _ in range(4)]
        for i in range(4):
            for k in range(4):
                s = Nm[i][0] * V[0][k]
                for j in range(1, 4):
                    s = s + Nm[i][j] * V[j][k]
                V2[i][k] = s
        for k in range(4):
            s = V2[0][k] * V2[0][k]
            for i in range(1, 4):
                s = s + V2[i][k] * V2[i][k]
            nrm = np.sqrt(s) + f32(1e-12)
            for i in range(4):
                V[i][k] = V2[i][k] / nrm
    ray = []
    for k in range(4):
        s = None
        for i in range(4):
            for j in range(4):
                term = V[i][k] * Nm[i][j] * V[j][k]
                s = term if s is None else s + term
        ray.append(s)
    V = np.stack([np.stack(row, -1) for row in V], -2)
    return V, np.stack(ray, -1), mp, mq


def same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


# --- inputs ----------------------------------------------------------------

def seeded_points(rng, shape, n):
    """P (shape, n, 3) and Q, a noisy rigid motion of P, and 0/1 weights."""
    P = rng.normal(0.0, 3.0, shape + (n, 3)).astype(f32)
    ang = rng.uniform(-np.pi, np.pi, shape)
    c, s = np.cos(ang), np.sin(ang)
    R = np.zeros(shape + (3, 3))
    R[..., 0, 0], R[..., 0, 1], R[..., 1, 0], R[..., 1, 1] = c, -s, s, c
    R[..., 2, 2] = 1.0
    t = rng.normal(0.0, 5.0, shape + (3,))
    Q = (np.einsum("...ij,...nj->...ni", R, P) + t[..., None, :]
         + rng.normal(0.0, 0.05, P.shape)).astype(f32)
    w = (rng.uniform(size=shape + (n,)) > 0.3).astype(f32)
    return P, Q, w


def horn_rows(source, n_rows, seed):
    """(P, Q, w) with ``n_rows`` leading rows: each a (5, 40, 3)-point
    hypothesis set and a (5, 256)-point refit-sized set, from a seed or
    from a case's RANSAC hypotheses (rolled along the hypothesis axis and
    perturbed, a row apiece)."""
    rng = np.random.RandomState(seed)
    if source == "seed":
        return seeded_points(rng, (n_rows, 5, 40), 3)
    P, Q, w = (x.numpy() for x in torch_horn_case.hypotheses(CASES[source]))
    out = [np.stack([np.roll(x, r, axis=1) for r in range(n_rows)])
           for x in (P, Q, w)]
    out[1] = (out[1] + rng.normal(0.0, 1e-3, out[1].shape)
              * (np.arange(n_rows) > 0)[:, None, None, None, None]
              ).astype(f32)
    return out


def batch_of(make, seed):
    """``make(n, seed)`` at ROWS rows, and at BATCH rows whose first ROWS
    are those and the others another seed's."""
    small = make(ROWS, seed)
    other = make(BATCH - ROWS, seed + 1000)
    big = [np.concatenate([a, b]) for a, b in zip(small, other)]
    return small, big


def refit_rows(source, n_rows, seed):
    """Refit-sized point sets: 256 points a row with 0/1 weights."""
    rng = np.random.RandomState(seed)
    if source == "seed":
        P, Q, w = seeded_points(rng, (n_rows,), 256)
        return P, Q, w
    p3d_t, _, p3d_l, valid, _ = torch_horn_case.ransac_inputs(CASES[source])
    P, Q, w = (x[0].numpy().astype(f32) for x in (p3d_t, p3d_l, valid))
    pick = rng.randint(0, P.shape[0], n_rows)
    jitter = rng.normal(0.0, 1e-3, (n_rows,) + Q.shape[1:]).astype(f32)
    return P[pick], Q[pick] + jitter, w[pick]


def t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


# --- batch invariance -------------------------------------------------------

SOURCES = ["seed", "case", "tie_case"]


@pytest.mark.parametrize("points", ["hypotheses", "refit"])
@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("fn", ["_horn_starts", "_kabsch"])
def test_horn_rows_do_not_depend_on_the_batch(fn, source, points):
    make = horn_rows if points == "hypotheses" else refit_rows
    small, big = batch_of(lambda n, s: make(source, n, s), 1)
    a = getattr(tm, fn)(*t(*small))
    b = getattr(tm, fn)(*t(*big))
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert same(x, y[:ROWS]), (fn, i)


def ransac_rows(source, n_rows, seed):
    """``ransac_pose``'s inputs with ``n_rows`` leading rows: a case's
    candidates (each row one, at a key of its own) or a seeded scene
    projected into the live camera."""
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, 2 ** 31, (n_rows, 2)).astype(np.int64)
    if source == "seed":
        P, Q, _ = seeded_points(rng, (n_rows,), 256)
        P[..., 2] = np.abs(P[..., 2]) + 2.0
        Q[..., 2] = np.abs(Q[..., 2]) + 2.0
        cam = torch_horn_case.case_config()[0]
        uv = tm._project(torch.from_numpy(Q), cam).numpy()
        uv = (uv + rng.normal(0.0, 0.5, uv.shape)).astype(f32)
        valid = rng.uniform(size=(n_rows, 256)) > 0.3
        return P, uv, Q, valid, keys
    p3d_t, uv_l, p3d_l, valid, _ = (
        x[0].numpy() for x in torch_horn_case.ransac_inputs(CASES[source]))
    pick = rng.randint(0, p3d_t.shape[0], n_rows)
    return p3d_t[pick], uv_l[pick], p3d_l[pick], valid[pick], keys


@pytest.mark.parametrize("source", SOURCES)
def test_ransac_rows_do_not_depend_on_the_batch(source):
    small, big = batch_of(lambda n, s: ransac_rows(source, n, s), 2)
    cam, lcfg = torch_horn_case.case_config()
    a = tm.ransac_pose(*t(*small), cam, lcfg)
    b = tm.ransac_pose(*t(*big), cam, lcfg)
    assert bool(a[4].any()), "no row accepted a pose"
    for i, (x, y) in enumerate(zip(a, b)):
        assert same(x, y[:ROWS]), i


def tick_rows(path, n_rows, seed):
    """``match_tick``'s inputs at a case with ``n_rows`` rows: the case's
    store (one copy, expanded), its live frame, and a query pose, key and
    consistency widening a row (the query within 1 m and 0.1 rad of the
    case's)."""
    rng = np.random.RandomState(seed)
    store, obs, xy, yaw, query, _, extra = torch_horn_case.case_inputs(path)

    def rows(x):
        return x.expand((n_rows,) + x.shape[1:])

    xy = xy + torch.from_numpy(rng.uniform(-1, 1, (n_rows, 2)).astype(f32))
    yaw = yaw + torch.from_numpy(rng.uniform(-0.1, 0.1, n_rows).astype(f32))
    key = torch.from_numpy(rng.randint(0, 2 ** 31, (n_rows, 2)))
    extra = torch.from_numpy(rng.uniform(0, 1, n_rows).astype(f32))
    return (type(store)(*(rows(x) for x in store)),
            type(obs)(*(rows(x) for x in obs)), xy, yaw, rows(query), key,
            extra)


def cat_rows(a, b):
    """Rows of ``b`` after ``a``'s; the store and the live frame, the same
    in every row, expanded again rather than copied."""
    (sa, oa, *qa), (sb, ob, *qb) = a, b
    n = sa.count.shape[0] + sb.count.shape[0]

    def rows(x):
        return x[:1].expand((n,) + x.shape[1:])

    return (type(sa)(*(rows(x) for x in sa)), type(oa)(*(rows(x) for x in oa)),
            *(torch.cat([x, y]) for x, y in zip(qa, qb)))


@pytest.mark.parametrize("source", ["case", "tie_case"])
def test_match_tick_rows_do_not_depend_on_the_batch(source):
    cam, lcfg = torch_horn_case.case_config()
    small = tick_rows(CASES[source], ROWS, 3)
    big = cat_rows(small, tick_rows(CASES[source], BATCH - ROWS, 1003))

    def run(a):
        *args, extra = a
        return tm.match_tick(*args, cam, lcfg, consistency_extra_m=extra)

    a, b = run(small), run(big)
    assert bool(a.ok.any()), "no row published an anchor"
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)[:ROWS]
        if x.dtype.is_floating_point:
            torch.testing.assert_close(y, x, rtol=0, atol=CPU_BATCH_ATOL,
                                       msg=f)
        else:
            assert torch.equal(x, y), f


# --- the reference's order --------------------------------------------------

@pytest.mark.parametrize("source", ["tie_case", "case", "seed_refit"])
def test_horn_starts_rounds_in_the_reference_order(source):
    if source == "seed_refit":
        P, Q, w = refit_rows("seed", 8, 5)
    else:
        P, Q, w = (x.numpy() for x in
                   torch_horn_case.hypotheses(CASES[source]))
    got = tm._horn_starts(*t(P, Q, w))
    want = horn_np(P, Q, w)
    for i, (g, w_) in enumerate(zip(got, want)):
        assert same(g.numpy(), w_), i


def test_horn_fixture_is_the_cpus():
    with np.load(torch_horn_case.FIXTURE) as z:
        fx = dict(z)
    now = torch_horn_case.horn_fixture()
    assert set(fx) == set(now)
    for k in now:
        assert same(fx[k], now[k]), k
    # the tie case holds Horn start ties: starts whose Rayleigh quotients
    # lie within float32's rounding of the best
    r = fx["rayleigh"].astype(np.float64)
    gap = r.max(-1, keepdims=True) - r
    assert ((gap > 0) & (gap < 2.0 ** -20 * np.abs(r).max(-1, keepdims=True))
            ).any()


# --- the VIO's normal equations ----------------------------------------------

VIO_ROWS, VIO_BATCH, VIO_POINTS = 15, 120, 256


def normal_rows(n_rows, seed):
    """Weighted Jacobian rows, Jacobian rows and residuals of ``n_rows``
    routes at the VIO's 256 points x 3 residuals."""
    rng = np.random.RandomState(seed)
    J = rng.normal(0.0, 300.0, (n_rows, VIO_POINTS * 3, 6)).astype(f32)
    w = (rng.uniform(size=(n_rows, VIO_POINTS * 3, 1)) > 0.2) \
        * rng.uniform(0.2, 1.0, (n_rows, VIO_POINTS * 3, 1))
    r = rng.normal(0.0, 2.0, (n_rows, VIO_POINTS * 3)).astype(f32)
    return (J * w).astype(f32), J, r


def test_normal_equations_do_not_depend_on_the_batch():
    small = normal_rows(VIO_ROWS, 11)
    other = normal_rows(VIO_BATCH - VIO_ROWS, 1011)
    big = [np.concatenate([a, b]) for a, b in zip(small, other)]
    a = ttr._normal_equations(*t(*small))
    b = ttr._normal_equations(*t(*big))
    for i, (x, y) in enumerate(zip(a, b)):
        assert same(x, y[:VIO_ROWS]), i


def test_normal_equations_round_in_the_tree_order():
    Jw, J, r = normal_rows(VIO_ROWS, 12)
    H, g = ttr._normal_equations(*t(Jw, J, r))
    H_np = tree_sum_np(Jw[..., :, :, None] * J[..., :, None, :], 1)[:, 0]
    g_np = tree_sum_np(Jw * r[..., None], 1)[:, 0]
    assert same(H.numpy(), H_np) and same(g.numpy(), g_np)


def pose_gn_rows(n_rows, seed):
    """``_pose_gn``'s inputs for ``n_rows`` routes: a body pose, 256 map
    points 2-15 m ahead of it seen from the true pose with pixel and depth
    noise, ~20 % of them unmatched, a perturbed start and an inertial
    prior near the truth."""
    rng = np.random.RandomState(seed)
    cam = tcfg.ours().camera
    yaw = rng.uniform(-np.pi, np.pi, n_rows)
    q = np.stack([np.zeros(n_rows), np.zeros(n_rows), np.sin(yaw / 2),
                  np.cos(yaw / 2)], -1).astype(f32)
    pos = np.concatenate([rng.normal(0.0, 20.0, (n_rows, 2)),
                          np.full((n_rows, 1), 0.3)], -1).astype(f32)
    local = np.stack([rng.uniform(2.0, 15.0, (n_rows, VIO_POINTS)),
                      rng.uniform(-4.0, 4.0, (n_rows, VIO_POINTS)),
                      rng.uniform(-0.5, 2.0, (n_rows, VIO_POINTS))], -1)
    c, s_ = np.cos(yaw)[:, None], np.sin(yaw)[:, None]
    X = np.stack([c * local[..., 0] - s_ * local[..., 1],
                  s_ * local[..., 0] + c * local[..., 1],
                  local[..., 2]], -1) + pos[:, None]
    X = X.astype(f32)
    R = ttr.quat_to_mat(torch.from_numpy(q))
    y = torch.matmul(torch.from_numpy(X) - torch.from_numpy(pos)[:, None], R)
    p_cam = ttr.base_to_cam(y - ttr._t_bc(cam, "cpu"))
    uv = (ttr._project(p_cam, cam).numpy()
          + rng.normal(0.0, 0.7, (n_rows, VIO_POINTS, 2))).astype(f32)
    z = (p_cam[..., 2].numpy()
         + rng.normal(0.0, 0.02, (n_rows, VIO_POINTS))).astype(f32)
    w_pt = (rng.uniform(size=(n_rows, VIO_POINTS)) > 0.2).astype(f32)
    dq = rng.normal(0.0, 0.02, (n_rows, 1))
    q0 = np.concatenate([np.zeros((n_rows, 2)), np.sin((yaw[:, None] + dq)
                                                       / 2),
                         np.cos((yaw[:, None] + dq) / 2)], -1).astype(f32)
    pos0 = (pos + rng.normal(0.0, 0.1, pos.shape)).astype(f32)
    prior_pos = (pos + rng.normal(0.0, 0.05, pos.shape)).astype(f32)
    return pos0, q0, X, uv, z, w_pt, prior_pos, q


@pytest.mark.parametrize("prior", [False, True])
def test_pose_gn_rows_do_not_depend_on_the_batch(prior):
    cam, vcfg = tcfg.ours().camera, tcfg.ours().vio
    small = pose_gn_rows(VIO_ROWS, 13)
    other = pose_gn_rows(VIO_BATCH - VIO_ROWS, 1013)
    big = [np.concatenate([a, b]) for a, b in zip(small, other)]

    def run(rows):
        pos0, q0, X, uv, z, w, prior_pos, prior_q = t(*rows)
        kw = dict(prior_pos=prior_pos, prior_q=prior_q, w_prior_pos=50.0,
                  w_prior_rot=200.0) if prior else {}
        return ttr._pose_gn(pos0, q0, X, uv, z, w, cam, vcfg, **kw)

    a, b = run(small), run(big)
    # the solve moved the perturbed start, and stayed finite
    assert float((a[0] - torch.from_numpy(small[0])).abs().max()) > 1e-3
    assert bool(torch.isfinite(a[0]).all() and torch.isfinite(a[1]).all())
    for x, y in zip(a, b):
        torch.testing.assert_close(y[:VIO_ROWS], x, rtol=0,
                                   atol=CPU_BATCH_ATOL)
