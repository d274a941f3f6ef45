"""The port's loop registration (``nclt_slam_tpu_torch/datasets/slam/
registration.py``: normals, FPFH, FPFH-RANSAC, ``register_loop`` and its
second half ``refine_and_gate``) against
the JAX package on the CPU.

Inputs: the JAX package's structured test cloud (``tests/test_registration
.py``: a ground strip, two walls, four pillars) and a pair of scans of the
slice's forest world, made from numpy seeds; the RANSAC picks come from the
same threefry key in both (``core/prng.randint`` is bit-exact).
Tolerances: normals and FPFH features (float32 k-NN covariances and
eigenvectors from two LAPACK builds) within 1e-4; on the structured cloud
RANSAC and registration transforms within 1e-4 and their consensus counts
and accept flags equal.  On the forest, whose FPFH descriptors are
near-identical, many points share one correspondence, and a 3-point
sample with two correspondences on one point leaves its Kabsch rotation to
the SVD routine (``tools/torch_ransac_probe.py``): there the accept flags
are held, and the rest where the RANSAC agrees.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
from test_registration import se3, structured_cloud  # noqa: E402
from torch_slam_scale_test import season_session, SEASONS  # noqa: E402

from nclt_slam_tpu.datasets.slam import registration as jreg  # noqa: E402
from nclt_slam_tpu_torch import interop  # noqa: E402
from nclt_slam_tpu_torch.core import prng  # noqa: E402
from nclt_slam_tpu_torch.datasets.slam import registration as treg  # noqa: E402

ATOL = 1e-4


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


def _pair(seed=2, yaw=0.6, t=(3.0, -2.0)):
    rng = np.random.RandomState(seed)
    dst = structured_cloud(rng)
    R, tr = se3(yaw, *t)
    src = ((dst - tr) @ R).astype(np.float32)
    src += rng.normal(0, 0.02, src.shape).astype(np.float32)
    valid = rng.rand(len(dst)) > 0.05
    return src, dst, valid, R, tr


def test_knn_matches_jax_with_invalid_points():
    src, _, valid, _, _ = _pair()
    src[:4] = src[4:8]                       # duplicate points: tied distances
    ji, jok = jreg._knn(jnp.asarray(src), jnp.asarray(valid), 16)
    ti, tok = treg._knn(_t(src), _t(valid), 16)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))


def test_normals_and_fpfh_match_jax():
    _, dst, valid, _, _ = _pair()
    jn = np.asarray(jreg.estimate_normals(jnp.asarray(dst),
                                          jnp.asarray(valid)))
    tn = treg.estimate_normals(_t(dst), _t(valid)).numpy()
    np.testing.assert_allclose(tn, jn, atol=ATOL)
    jf = np.asarray(jreg.fpfh(jnp.asarray(dst), jnp.asarray(valid)))
    tf = treg.fpfh(_t(dst), _t(valid)).numpy()
    assert tf.shape == (len(dst), 33)
    np.testing.assert_allclose(tf, jf, atol=ATOL)


def test_ransac_matches_jax():
    src, dst, valid, R, tr = _pair()
    v = jnp.asarray(valid)
    jR, jt, jn, jok = jax.jit(jreg.ransac_registration)(
        jnp.asarray(src), v, jnp.asarray(dst), v, jax.random.PRNGKey(0))
    tR, tt, tn, tok = treg.ransac_registration(
        _t(src), _t(valid), _t(dst), _t(valid), prng.PRNGKey(0, "cpu"))
    assert bool(tok) == bool(jok) and bool(tok)
    assert int(tn) == int(jn)
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=ATOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=ATOL)
    assert np.linalg.norm(tt.numpy() - tr) < 1.0


def test_register_loop_matches_jax_on_structured_cloud():
    src, dst, valid, R, tr = _pair(seed=5, yaw=-0.3, t=(1.0, 2.0))
    key = jax.random.PRNGKey(3)
    args = (src, valid, dst, valid)
    want = jax.jit(jreg.register_loop)(*map(jnp.asarray, args), key)
    got = treg.register_loop(*map(_t, args), interop.from_numpy_tree(
        np.asarray(key), "cpu"))
    assert bool(got.ok) == bool(want.ok) and bool(got.ok)
    assert int(got.n_inliers) == int(want.n_inliers)
    np.testing.assert_allclose(float(got.rmse), float(want.rmse), atol=ATOL)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=ATOL)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=ATOL)
    assert np.linalg.norm(got.t.numpy() - tr) < 0.1


@pytest.fixture(scope="module")
def forest_pairs():
    """Scans of the slice's forest world (the SLAM tool's winter season,
    401 scans x 128 points on two laps)."""
    scans, valid, _, _, _ = season_session(401, 2.0, 128, SEASONS[0][1])
    return scans, valid


@pytest.mark.parametrize("pair", [(86, 286), (10, 210), (30, 31), (5, 120)])
def test_register_loop_on_forest_scans(forest_pairs, pair):
    """Revisits (accepted), consecutive scans and a pair from opposite sides
    of the loop (rejected).  The forest's FPFH descriptors are
    near-identical, so the RANSAC's samples often hold two correspondences
    on one point, whose Kabsch rotation the SVD routine decides: the
    features and the accept flag are held; the consensus and the transforms
    where the RANSAC transforms agree."""
    scans, valid = forest_pairs
    i, j = pair
    key = jax.random.split(jax.random.PRNGKey(i), 2)[1]
    tkey = interop.from_numpy_tree(np.asarray(key), "cpu")
    args = (scans[j], valid[j], scans[i], valid[i])
    for m in (i, j):
        np.testing.assert_allclose(
            treg.fpfh(_t(scans[m]), _t(valid[m])).numpy(),
            np.asarray(jax.jit(jreg.fpfh)(jnp.asarray(scans[m]),
                                          jnp.asarray(valid[m]))),
            atol=ATOL)
    want = jax.jit(jreg.register_loop)(*map(jnp.asarray, args), key)
    got = treg.register_loop(*map(_t, args), tkey)
    assert bool(got.ok) == bool(want.ok)
    if pair[1] - pair[0] == 200:
        assert bool(got.ok)
    jR0 = jax.jit(jreg.ransac_registration)(*map(jnp.asarray, args), key)[0]
    tR0 = treg.ransac_registration(*map(_t, args), tkey)[0]
    if np.abs(tR0.numpy() - np.asarray(jR0)).max() <= ATOL:
        assert int(got.n_inliers) == int(want.n_inliers)
        np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R),
                                   atol=ATOL)
        np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t),
                                   atol=ATOL)


@pytest.mark.parametrize("pair", [(86, 286), (10, 210), (30, 31), (5, 120)])
def test_refine_and_gate_from_jax_ransac(forest_pairs, pair):
    """``register_loop``'s second half, fed JAX's own RANSAC result, gives
    JAX's registration: the accept flag equal, the transform and RMSE within
    1e-4 (the comparison ``chip_smoke.py`` makes on the card where the two
    RANSAC stages differ)."""
    scans, valid = forest_pairs
    i, j = pair
    key = jax.random.split(jax.random.PRNGKey(i), 2)[1]
    args = (scans[j], valid[j], scans[i], valid[i])
    jargs = list(map(jnp.asarray, args))
    ransac = jax.jit(jreg.ransac_registration)(*jargs, key)
    want = jax.jit(jreg.register_loop)(*jargs, key)
    got = treg.refine_and_gate(*map(_t, args), *map(_t, ransac))
    assert bool(got.ok) == bool(want.ok)
    assert int(got.n_inliers) == int(want.n_inliers)
    np.testing.assert_allclose(float(got.rmse), float(want.rmse), atol=ATOL)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=ATOL)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=ATOL)
