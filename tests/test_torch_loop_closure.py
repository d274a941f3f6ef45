"""The port's loop detection (``nclt_slam_tpu_torch/datasets/slam/
loop_closure.py``: ScanContext, its rotation-invariant distance and the
dense and two-stage detectors) against the JAX package on the CPU.

Scans come from the slice's own generator (``tools/torch_slam_scale_test.py``,
the same numpy draws as the JAX tool), in a small world.  Tolerances: ring
and sector bins are float32 truncations of ``hypot`` / ``atan2``, and one
ulp of ``atan2`` can move a point across a sector edge between the two
packages, so descriptors are compared by the share of equal cells (at least
99.9 %); ScanContext
distances within 1e-5; the loop sets of both detectors equal.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
from torch_slam_scale_test import (  # noqa: E402
    build_world,
    loop_trajectory,
    make_scans,
)

from nclt_slam_tpu.datasets.slam import loop_closure as jlc  # noqa: E402
from nclt_slam_tpu_torch.datasets.slam import loop_closure as tlc  # noqa: E402

EQUAL_CELLS = 0.999
DIST_ATOL = 1e-5


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


@pytest.fixture(scope="module")
def session():
    rng = np.random.RandomState(3)
    centers, radii, heights = build_world(rng, n_trees=160, extent=60.0)
    xy, yaw = loop_trajectory(40, radius=35.0, laps=1.3)
    scans, valid = make_scans(centers, radii, heights, xy, yaw, rng,
                              n_pts=192, max_range=30.0, jitter=0.02)
    jd = np.array(jax.jit(jax.vmap(jlc.scan_context))(
        jnp.asarray(scans), jnp.asarray(valid)))
    return scans, valid, xy, jd


def test_hypot_follows_jax():
    """Within two ulps of ``jnp.hypot`` everywhere, equal in 99 %."""
    rng = np.random.RandomState(0)
    x = (rng.normal(0, 30, 5000) * rng.rand(5000) ** 4).astype(np.float32)
    y = rng.normal(0, 30, 5000).astype(np.float32)
    x[:3], y[:3] = 0.0, (0.0, np.inf, -2.0)
    got = tlc._hypot(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    want = np.asarray(jnp.hypot(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_array_equal(got[:3], want[:3])
    assert (got == want).mean() >= 0.99
    np.testing.assert_array_max_ulp(got[3:], want[3:], maxulp=2)


def test_scan_context_matches_jax(session):
    scans, valid, _, jd = session
    td = tlc.scan_context(torch.from_numpy(scans),
                          torch.from_numpy(valid)).numpy()
    assert td.shape == jd.shape == (40, 20, 60)
    assert (td == jd).mean() >= EQUAL_CELLS, (td == jd).mean()
    # one scan alone gives the same as in the batch
    np.testing.assert_array_equal(
        tlc.scan_context(torch.from_numpy(scans[7]),
                         torch.from_numpy(valid[7])).numpy(), td[7])


def test_scan_context_range_and_empty():
    pts = np.array([[1.0, 0.0, 2.0], [90.0, 0.0, 5.0], [0.0, -1.0, -0.5],
                    [0.0, 0.0, 0.0]], np.float32)
    v = np.array([True, True, True, False])
    jd = np.asarray(jlc.scan_context(jnp.asarray(pts), jnp.asarray(v)))
    td = tlc.scan_context(torch.from_numpy(pts), torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(td, jd)
    empty = tlc.scan_context(torch.zeros(5, 3),
                             torch.zeros(5, dtype=torch.bool))
    assert (empty == 0).all()


def test_sc_distance_matches_jax(session):
    _, _, _, jd = session
    d = torch.from_numpy(jd)
    rolled = np.roll(jd[3], 17, axis=1)
    pairs = [(jd[0], jd[30]), (jd[3], rolled), (jd[5], jd[6]),
             (jd[5], np.zeros_like(jd[5])), (np.zeros_like(jd[5]), jd[5])]
    for a, b in pairs:
        jdist, jshift = jlc.sc_distance(jnp.asarray(a), jnp.asarray(b))
        tdist, tshift = tlc.sc_distance(torch.from_numpy(a),
                                        torch.from_numpy(b))
        assert abs(float(tdist) - float(jdist)) <= DIST_ATOL
        assert int(tshift) == int(jshift)
    # a column shift of a descriptor is found at distance ~0
    dist, shift = tlc.sc_distance(d[3], torch.from_numpy(rolled))
    assert float(dist) < 1e-5 and int(shift) == 60 - 17


def _loop_set(i, j, f):
    return {(int(a), int(b)) for a, b, ok in zip(np.asarray(i),
                                                  np.asarray(j),
                                                  np.asarray(f)) if ok}


@pytest.mark.parametrize("own_descriptors", [False, True])
def test_detectors_match_jax(session, own_descriptors):
    """Dense and two-stage detectors, on JAX's descriptors and on the
    port's own: the same loop sets, and (on JAX's descriptors) the same
    ranked pairs."""
    scans, valid, xy, jd = session
    td = tlc.scan_context(torch.from_numpy(scans), torch.from_numpy(valid)) \
        if own_descriptors else torch.from_numpy(jd)
    kw = dict(min_gap=10, gps_radius=12.0, sc_thresh=0.4, max_loops=8)
    pos, v = jnp.asarray(xy), jnp.ones(40, bool)
    j_dense = jlc.detect_loops(jnp.asarray(jd), pos, v, **kw)
    j_scal = jlc.detect_loops_scalable(jnp.asarray(jd), pos, v,
                                       shortlist=128, **kw)
    tpos, tv = torch.from_numpy(xy), torch.ones(40, dtype=torch.bool)
    t_dense = tlc.detect_loops(td, tpos, tv, **kw)
    t_scal = tlc.detect_loops_scalable(td, tpos, tv, shortlist=128, **kw)
    assert _loop_set(*j_dense), "the dense detector found no loops"
    assert _loop_set(*t_dense) == _loop_set(*j_dense)
    assert _loop_set(*t_scal) == _loop_set(*j_scal) == _loop_set(*j_dense)
    if not own_descriptors:
        for t, j in ((t_dense, j_dense), (t_scal, j_scal)):
            for a, b in zip(t, j):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_ring_key_matches_jax(session):
    _, _, _, jd = session
    np.testing.assert_allclose(tlc.ring_key(torch.from_numpy(jd)).numpy(),
                               np.asarray(jlc.ring_key(jnp.asarray(jd))),
                               rtol=1e-6, atol=1e-7)
