"""The port's ICP module (``nclt_slam_tpu_torch/datasets/slam/icp.py``)
against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both.  Tolerances:
single solves (Kabsch, point-to-point and point-to-plane ICP, which both
packages run in float32 with their own LAPACK SVD / solve and summation
order) agree within 1e-4 in rotation entries and 1e-4 m in translation;
the short scan-to-map odometry chain, whose rounding adds up over its
scans, within 1e-3 m / 1e-3; the local map and the ground RANSAC (same
threefry draws, integer picks) exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nclt_slam_tpu.datasets.slam import icp as jicp
from nclt_slam_tpu.datasets.slam.pipeline import (
    run_icp_odometry as j_odometry,
    run_icp_odometry_scan as j_odometry_scan,
)
from nclt_slam_tpu_torch import interop
from nclt_slam_tpu_torch.core import prng
from nclt_slam_tpu_torch.datasets.slam import icp
from nclt_slam_tpu_torch.datasets.slam.pipeline import (
    run_icp_odometry,
    run_icp_odometry_scan,
)

ATOL = 1e-4
CHAIN_ATOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port on one CPU thread: at these sizes torch's intra-op threads
    cost more than they give (an ICP iteration of 128 points against a
    1280-point map took ~2 ms on one thread and ~50 ms on eight, on an
    8-core CPU host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rz(th):
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def structured_scene(rng, n_wall=80, n_scatter=96):
    """Two walls + scatter (the JAX package's ICP test scene)."""
    wall1 = np.stack([np.linspace(2, 12, n_wall), np.full(n_wall, 3.0),
                      rng.uniform(0, 2, n_wall)], -1)
    wall2 = np.stack([np.full(n_wall, 10.0), np.linspace(-5, 3, n_wall),
                      rng.uniform(0, 2, n_wall)], -1)
    scatter = rng.uniform(-5, 15, (n_scatter, 3)) * np.array([1, 1, 0.15])
    return np.concatenate([wall1, wall2, scatter]).astype(np.float32)


def test_nearest_matches_jax_with_ties_and_invalid():
    rng = np.random.RandomState(0)
    src = rng.uniform(-3, 3, (64, 3)).astype(np.float32)
    dst = rng.uniform(-3, 3, (200, 3)).astype(np.float32)
    dst[100:110] = dst[90:100]               # duplicated points: exact ties
    dv = rng.rand(200) > 0.2
    ji, jd = jicp._nearest(jnp.asarray(src), jnp.asarray(dst),
                           jnp.asarray(dv))
    ti, td = icp._nearest(_t(src), _t(dst), _t(dv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("planar", [False, True])
def test_kabsch_matches_jax(planar):
    """Rank 3 and rank 2 (planar points: the third singular pair's signs
    are free; the det-sign fix makes R unique)."""
    rng = np.random.RandomState(1 + planar)
    P = rng.uniform(-5, 5, (50, 3)).astype(np.float32)
    if planar:
        P[:, 2] = 0.0
    R = _rz(0.4) @ np.array([[1, 0, 0], [0, np.cos(0.2), -np.sin(0.2)],
                             [0, np.sin(0.2), np.cos(0.2)]], np.float32)
    Q = (P @ R.T + np.array([1.0, -2.0, 0.5], np.float32)
         + rng.normal(0, 0.01, P.shape)).astype(np.float32)
    w = (rng.rand(50) > 0.3).astype(np.float32)
    jR, jt = jicp._kabsch_weighted(jnp.asarray(P), jnp.asarray(Q),
                                   jnp.asarray(w))
    tR, tt = icp._kabsch_weighted(_t(P), _t(Q), _t(w))
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=ATOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=ATOL)
    assert abs(np.linalg.det(tR.numpy()) - 1.0) < 1e-5


def _icp_pair(seed):
    rng = np.random.RandomState(seed)
    dst = structured_scene(rng)
    R_true = _rz(0.05)
    t_true = np.array([0.3, -0.2, 0.0], np.float32)
    src = ((dst - t_true) @ R_true).astype(np.float32)
    src += rng.normal(0, 0.01, src.shape).astype(np.float32)
    valid = rng.rand(len(dst)) > 0.05
    return src, dst, valid


def test_point_to_point_matches_jax():
    src, dst, valid = _icp_pair(3)
    R0 = _rz(0.02)
    t0 = np.array([0.1, 0.0, 0.0], np.float32)
    j = jax.jit(lambda s, d: jicp.icp_point_to_point(
        s, jnp.asarray(valid), d, jnp.asarray(valid), R0=jnp.asarray(R0),
        t0=jnp.asarray(t0), iters=25))(jnp.asarray(src), jnp.asarray(dst))
    t = icp.icp_point_to_point(_t(src), _t(valid), _t(dst), _t(valid),
                               R0=_t(R0), t0=_t(t0), iters=25)
    np.testing.assert_allclose(t.R.numpy(), np.asarray(j.R), atol=ATOL)
    np.testing.assert_allclose(t.t.numpy(), np.asarray(j.t), atol=ATOL)
    np.testing.assert_allclose(float(t.rmse), float(j.rmse), atol=ATOL)
    assert int(t.n_inliers) == int(j.n_inliers)
    assert t.n_inliers.dtype == torch.int32
    moved = src @ t.R.numpy().T + t.t.numpy()
    assert np.linalg.norm(moved - dst, axis=-1)[valid].mean() < 0.05


def test_point_to_plane_matches_jax():
    from nclt_slam_tpu.datasets.slam.registration import estimate_normals

    src, dst, valid = _icp_pair(4)
    normals = np.asarray(estimate_normals(jnp.asarray(dst),
                                          jnp.asarray(valid)))
    j = jicp.icp_point_to_plane(jnp.asarray(src), jnp.asarray(valid),
                                jnp.asarray(dst), jnp.asarray(normals),
                                jnp.asarray(valid), iters=15)
    t = icp.icp_point_to_plane(_t(src), _t(valid), _t(dst), _t(normals),
                               _t(valid), iters=15)
    np.testing.assert_allclose(t.R.numpy(), np.asarray(j.R), atol=ATOL)
    np.testing.assert_allclose(t.t.numpy(), np.asarray(j.t), atol=ATOL)
    np.testing.assert_allclose(float(t.rmse), float(j.rmse), atol=ATOL)
    assert int(t.n_inliers) == int(j.n_inliers)


def test_rodrigues_matches_jax():
    w = np.array([0.03, -0.2, 0.11], np.float32)
    np.testing.assert_allclose(icp._rodrigues(_t(w)).numpy(),
                               np.asarray(jicp._rodrigues(jnp.asarray(w))),
                               atol=1e-6)


def test_ground_ransac_matches_jax():
    rng = np.random.RandomState(2)
    ground = np.column_stack([rng.uniform(-10, 10, (200, 2)),
                              rng.normal(0.0, 0.02, 200)])
    objects = np.column_stack([rng.uniform(-10, 10, (100, 2)),
                               rng.uniform(0.8, 2.5, 100)])
    pts = np.concatenate([ground, objects]).astype(np.float32)
    valid = rng.rand(300) > 0.1
    jv, jn, jd = jicp.remove_ground_ransac(jnp.asarray(pts),
                                           jnp.asarray(valid),
                                           jax.random.PRNGKey(5))
    tv, tn, td = icp.remove_ground_ransac(_t(pts), _t(valid),
                                          prng.PRNGKey(5, "cpu"))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-5)
    np.testing.assert_allclose(float(td), float(jd), atol=1e-5)
    assert tv.numpy()[200:][valid[200:]].mean() > 0.9
    assert tv.numpy()[:200].mean() < 0.1


def test_local_map_ring_matches_jax():
    jm = jicp.init_local_map(4, 8)
    tm = icp.init_local_map(4, 8, "cpu")
    for i in range(6):
        pts = np.full((8, 3), float(i), np.float32)
        v = np.arange(8) % (i + 1) != 0
        jm = jicp.local_map_insert(jm, jnp.asarray(pts), jnp.asarray(v))
        tm = icp.local_map_insert(tm, _t(pts), _t(v))
    want = interop.from_numpy_tree(jm, "cpu")
    for name in ("pts", "valid", "cursor"):
        assert torch.equal(getattr(tm, name), getattr(want, name)), name
    fp, fv = icp.local_map_flat(tm)
    jp, jv = jicp.local_map_flat(jm)
    np.testing.assert_array_equal(fp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(fv.numpy(), np.asarray(jv))


def _pillar_session(T_n=12, N=128, seed=11):
    """A structured world of pillars and a square drive (the JAX package's
    odometry pipeline test, shortened)."""
    rng = np.random.RandomState(seed)
    world = []
    for px, py in rng.uniform(-20, 20, (60, 2)):
        ang = rng.uniform(0, 2 * np.pi, 12)
        world.append(np.column_stack([px + 0.3 * np.cos(ang),
                                      py + 0.3 * np.sin(ang),
                                      rng.uniform(0, 3, 12)]))
    world = np.concatenate(world)
    gt, (x, y, th) = [], (0.0, 0.0, 0.0)
    for t in range(T_n):
        gt.append((x, y, th))
        if t % 4 == 3:
            th += np.pi / 2
        else:
            x, y = x + 3 * np.cos(th), y + 3 * np.sin(th)
    gt = np.asarray(gt)
    scans = np.zeros((T_n, N, 3), np.float32)
    valid = np.zeros((T_n, N), bool)
    for t, (x, y, th) in enumerate(gt):
        rel = world - np.array([x, y, 0.0])
        d = np.hypot(rel[:, 0], rel[:, 1])
        near = np.argsort(d)[:N]
        c, s = np.cos(-th), np.sin(-th)
        scans[t, :, 0] = c * rel[near, 0] - s * rel[near, 1]
        scans[t, :, 1] = s * rel[near, 0] + c * rel[near, 1]
        scans[t, :, 2] = rel[near, 2]
        valid[t] = d[near] < 25.0
        scans[t] += rng.normal(0, 0.01, (N, 3))
    odom = np.tile(np.eye(4, dtype=np.float32), (T_n, 1, 1))
    for t in range(1, T_n):
        ci, si = np.cos(gt[t - 1, 2]), np.sin(gt[t - 1, 2])
        dxy = np.array([[ci, si], [-si, ci]]) @ (gt[t, :2] - gt[t - 1, :2])
        dth = gt[t, 2] - gt[t - 1, 2] + 0.01
        odom[t, :2, :2] = [[np.cos(dth), -np.sin(dth)],
                           [np.sin(dth), np.cos(dth)]]
        odom[t, :2, 3] = dxy * 1.02
    return scans, valid, odom, gt


@pytest.mark.parametrize("resident", [False, True])
def test_odometry_chain_matches_jax(resident):
    """The host-loop and the device-resident odometry against JAX's."""
    scans, valid, odom, gt = _pillar_session()
    j_fn, t_fn = (j_odometry_scan, run_icp_odometry_scan) if resident \
        else (j_odometry, run_icp_odometry)
    jp, jr = j_fn(scans, valid, odom, local_map_scans=6)
    tp, tr = t_fn(scans, valid, odom, local_map_scans=6, device="cpu")
    assert tp.shape == (len(scans), 4, 4) and tr.shape == (len(scans),)
    np.testing.assert_allclose(tp, jp, atol=CHAIN_ATOL)
    np.testing.assert_allclose(tr, jr, atol=CHAIN_ATOL)
    assert np.hypot(*(tp[:, :2, 3] - gt[:, :2]).T).max() < 0.5
