"""Slice 4 of the port, the LiDAR SLAM path, against the JAX package on the
CPU: ``run_slam`` end to end (ICP odometry, ScanContext loops, FPFH-RANSAC
loop registration, the junction-reduced PGO), and the generator copy of the
port's scale tool.

The long session is the scale tool's winter season cut to 401 scans x 128
points on its two laps (401 scans put every revisit on the first lap's
scan positions, so loops are found) with a 10-scan local map: from 300
scans ``run_slam`` takes the device-resident odometry and the two-stage
loop search, from 400 the fused PGO.  A short 40-scan session takes the
host-loop odometry, the dense loop search and the dense PGO.

What is held, and why:

- loop pairs and ``found`` flags: equal;
- ICP: the open poses and RMSEs within 1e-3 m / rad up to the first
  correspondence flip.  A scan-to-map ICP is a chain of argmins: two
  map points at nearly one distance from a moved point (ulps apart, the
  float32 Kabsch sums round differently in the two packages) can swap,
  and from that scan on the two open chains differ by centimetres to a
  metre (``FIRST_FLIP`` is where it happens on this session);
- loop measurements: within 1e-3 for at least 90 % of the accepted loops.
  The forest's FPFH descriptors are near-identical (alike trunks), so many
  points share one correspondence, and a 3-point RANSAC sample with two
  correspondences on one point has a Kabsch rotation that the SVD routine
  decides (``tools/torch_ransac_probe.py``): for every loop beyond 1e-3
  the FPFH features of both scans must agree within 1e-4 and the RANSAC
  transforms differ;
- the optimized poses: the port's PGO on the JAX run's own pose graph
  within 1e-3 m of JAX's optimized poses (the free-running chains differ
  after the flip, so their graphs do);
- the short session (without registration: the same RANSAC flip changed
  one accept flag of this session): every output within 1e-3.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import slam_scale_test as jtool  # noqa: E402
import torch_slam_scale_test as ttool  # noqa: E402

from nclt_slam_tpu.datasets.slam import loop_closure as jlc  # noqa: E402
from nclt_slam_tpu.datasets.slam import pipeline as jpipe  # noqa: E402
from nclt_slam_tpu.datasets.slam import registration as jreg  # noqa: E402
from nclt_slam_tpu_torch import interop  # noqa: E402
from nclt_slam_tpu_torch.core import prng  # noqa: E402
from nclt_slam_tpu_torch.datasets.slam import loop_closure as tlc  # noqa: E402
from nclt_slam_tpu_torch.datasets.slam import pipeline as tpipe  # noqa: E402
from nclt_slam_tpu_torch.datasets.slam import registration as treg  # noqa: E402

T_LONG, PTS = 401, 128
KW = dict(loop_min_gap=T_LONG // 8, sc_thresh=0.35, max_loops=64,
          sc_max_range=50.0, local_map_scans=10)
ATOL = 1e-3
MEAS_SHARE = 0.9
FIRST_FLIP = 50


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


def _capture(module, name, store, key):
    inner = getattr(module, name)

    def wrapped(graph, *a, **kw):
        store[key] = graph
        return inner(graph, *a, **kw)
    return wrapped


@pytest.fixture(scope="module")
def long_runs():
    scans, valid, odom, xy, km = ttool.season_session(
        T_LONG, 2.0, PTS, ttool.SEASONS[0][1])
    graphs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlc, "optimize_pose_graph_fast",
                   _capture(jlc, "optimize_pose_graph_fast", graphs, "jax"))
        mp.setattr(tpipe, "optimize_pose_graph_fast",
                   _capture(tpipe, "optimize_pose_graph_fast", graphs,
                            "port"))
        inner = tpipe.detect_loops_scalable
        mp.setattr(tpipe, "detect_loops_scalable", lambda *a, **kw: graphs
                   .setdefault("detected", inner(*a, **kw)))
        jo = jpipe.run_slam(scans, valid, odom_pred=odom, **KW)
        stage_s = {}
        to = tpipe.run_slam(scans, valid, odom_pred=odom, device="cpu",
                            stage_s=stage_s, **KW)
    return dict(scans=scans, valid=valid, xy=xy, km=km, jax=jo, port=to,
                jg=jax.tree_util.tree_map(np.asarray, graphs["jax"]),
                tg=graphs["port"], stage_s=stage_s,
                detected=graphs["detected"][2].numpy())


def test_long_session_loops_equal(long_runs):
    jo, to = long_runs["jax"], long_runs["port"]
    for a, b in zip(to["loops"], jo["loops"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(to["loops"][2]).sum() >= 10
    assert set(long_runs["stage_s"]) == set(tpipe.STAGES)


def test_long_session_open_chain_until_first_flip(long_runs):
    jo, to = long_runs["jax"], long_runs["port"]
    d = np.abs(to["poses_open"] - jo["poses_open"]).max(1)
    assert d[:FIRST_FLIP].max() <= ATOL, np.flatnonzero(d > ATOL)[:3]
    np.testing.assert_allclose(to["rmses"][:FIRST_FLIP],
                               jo["rmses"][:FIRST_FLIP], atol=ATOL)
    # both chains track the drive all the same (1 % of the path)
    for out in (jo, to):
        for key in ("poses_open", "poses_optimized"):
            assert np.isfinite(out[key]).all()
            assert ttool.ate(out[key], long_runs["xy"]) < \
                10.0 * long_runs["km"]


def test_long_session_loop_measurements(long_runs):
    jg, tg = long_runs["jg"], long_runs["tg"]
    found = jg.loop_valid
    np.testing.assert_array_equal(tg.loop_valid.numpy(), found)
    gap = np.abs(tg.loop_meas.numpy() - jg.loop_meas).max(1)
    assert (gap[found] <= ATOL).mean() >= MEAS_SHARE, gap[found]
    # the loops beyond: the FPFH features agree, the RANSAC choices do not
    scans, valid = long_runs["scans"], long_runs["valid"]
    ransac = jax.jit(jreg.ransac_registration)
    features = jax.jit(jreg.fpfh)
    key, tkey = jax.random.PRNGKey(0), prng.PRNGKey(0, "cpu")
    for e in np.flatnonzero(long_runs["detected"]):   # one key a candidate
        key, k = jax.random.split(key)
        tkey, tk = prng.split(tkey).unbind(0)
        if not found[e] or gap[e] <= ATOL:
            continue
        i, j = int(jg.loop_i[e]), int(jg.loop_j[e])
        args = [scans[j], valid[j], scans[i], valid[i]]
        jR0 = ransac(*map(jnp.asarray, args), k)[0]
        tR0 = treg.ransac_registration(*map(torch.from_numpy, args), tk)[0]
        assert np.abs(tR0.numpy() - np.asarray(jR0)).max() > ATOL
        for m in (i, j):
            np.testing.assert_allclose(
                treg.fpfh(torch.from_numpy(scans[m]),
                          torch.from_numpy(valid[m])).numpy(),
                np.asarray(features(jnp.asarray(scans[m]),
                                    jnp.asarray(valid[m]))), atol=1e-4)


@pytest.mark.parametrize("backend", ["fused", "xla"])
def test_long_session_pgo_on_jax_graph(long_runs, backend):
    """The port's PGO (on the CPU: K4's plain version) on the JAX run's own
    graph against JAX's route of the same name (the fused one gave JAX's
    optimized poses)."""
    graph = interop.from_numpy_tree(long_runs["jg"], "cpu")
    got = tlc.optimize_pose_graph_fast(graph, iters=15, backend=backend)
    want = long_runs["jax"]["poses_optimized"] if backend == "fused" else \
        np.asarray(jlc.optimize_pose_graph_fast(long_runs["jg"], iters=15,
                                                backend=backend))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def _short_session():
    rng = np.random.RandomState(3)
    centers, radii, heights = ttool.build_world(rng, n_trees=160,
                                                extent=60.0)
    xy, yaw = ttool.loop_trajectory(40, radius=35.0, laps=1.3)
    scans, valid = ttool.make_scans(centers, radii, heights, xy, yaw, rng,
                                    n_pts=192, max_range=30.0, jitter=0.02)
    return scans, valid, ttool.noisy_odom(xy, yaw, rng), xy


def test_short_session_host_loop_and_dense_pgo():
    """Without registration (loop edges assume an exact revisit), so that
    the dense route's outputs are held without the registration's flips."""
    scans, valid, odom, xy = _short_session()
    kw = dict(loop_min_gap=10, sc_thresh=0.4, max_loops=8,
              local_map_scans=10, register_loops=False)
    jo = jpipe.run_slam(scans, valid, odom_pred=odom, **kw)
    to = tpipe.run_slam(scans, valid, odom_pred=odom, device="cpu", **kw)
    for a, b in zip(to["loops"], jo["loops"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(to["loops"][2]).any()
    for key in ("poses_open", "poses_optimized", "rmses"):
        np.testing.assert_allclose(to[key], jo[key], atol=ATOL, rtol=0)


def test_tool_generators_are_the_jax_tools():
    """The port's tool draws the JAX tool's sessions bit for bit."""
    assert ttool.SEASONS == jtool.SEASONS
    for tool in (jtool, ttool):
        rng = np.random.RandomState(11)
        world = tool.build_world(rng, n_trees=120, extent=80.0)
        traj = tool.loop_trajectory(30, radius=40.0, laps=1.5)
        srng = np.random.RandomState(17)
        scans = tool.make_scans(*world, *traj, srng, n_pts=96,
                                **jtool.SEASONS[1][1])
        odom = tool.noisy_odom(*traj, srng)
        if tool is jtool:
            want = (world, traj, scans, odom)
    got = (world, traj, scans, odom)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert (scans[1].sum(1) > 0).all()
