"""The port's anchor matcher against the JAX package on the CPU: the Horn
/ power-iteration Kabsch, and ``match_tick`` on the forest strip of
``tests/test_landmarks.py`` for a batch of query poses.

Tolerances.  ``_kabsch`` sums its 4x4 products in the order of the JAX
package's unrolled scalar sums, but XLA fuses multiply-adds where the port
rounds each product: R and t agree to 1e-5.  The RANSAC
samples are bit-exact (threefry ``randint``), so every discrete outcome of
``match_tick`` (published, reason, inlier count) is equal and the anchor
position agrees to 1e-3 m.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nclt_slam_tpu.baselines import configs as jbase
from nclt_slam_tpu.config import DEFAULT
from nclt_slam_tpu.landmarks import init_store, match_tick, record_tick
from nclt_slam_tpu.landmarks.store import LandmarkStore
from nclt_slam_tpu.landmarks.matcher import _kabsch as j_kabsch
from nclt_slam_tpu.sensors.depth import camera_pose
from nclt_slam_tpu.sensors.features import (
    Observation,
    build_scene_features,
    observe,
)
from nclt_slam_tpu_torch import interop
from nclt_slam_tpu_torch.baselines import configs as tbase
from nclt_slam_tpu_torch.config import DEFAULT as TDEFAULT
from nclt_slam_tpu_torch.landmarks import matcher as tm

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import torch_divergence_probe as probe  # noqa: E402

# match_tick's JAX inputs at 09_se_ne's rgbd repeat, tick 150, and at
# 12_ne_mid's, tick 45, cut by tools/torch_divergence_probe.py
# --case-from from the probe's dumps
CASE = Path(__file__).parent / "data" / "torch_matcher_case.npz"
TIE_CASE = Path(__file__).parent / "data" / "torch_matcher_tie_case.npz"

# the test workers share the CPU: one intra-op thread each keeps their
# torch thread pools from oversubscribing it
torch.set_num_threads(1)

CFG = DEFAULT


def _stack(trees):
    return interop.from_numpy_tree(jax.tree_util.tree_map(
        lambda *xs: np.stack([np.asarray(x) for x in xs]), *trees), "cpu")


def test_kabsch_matches_jax():
    rng = np.random.RandomState(0)
    B, N = 6, 40
    P = rng.normal(0, 3, (B, N, 3)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, B)
    axis = rng.normal(size=(B, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    from scipy.spatial.transform import Rotation
    R = Rotation.from_rotvec(axis * ang[:, None]).as_matrix()
    t = rng.normal(0, 5, (B, 3))
    Q = (np.einsum("bij,bnj->bni", R, P) + t[:, None]
         + rng.normal(0, 0.01, (B, N, 3))).astype(np.float32)
    w = (rng.rand(B, N) > 0.3).astype(np.float32)
    jR, jt = j_kabsch(jnp.asarray(P), jnp.asarray(Q), jnp.asarray(w))
    tR, tt = tm._kabsch(torch.from_numpy(P), torch.from_numpy(Q),
                        torch.from_numpy(w))
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)
    np.testing.assert_allclose(tR.numpy(), R, atol=1e-2)   # and it is right


@pytest.fixture(scope="module")
def strip_store():
    """The forest strip and a landmark store recorded along it."""
    rng = np.random.RandomState(5)
    N = 24
    xy = np.zeros((N, 2), np.float32)
    for i in range(N):
        xy[i] = (4.0 * i, 4.0 if i % 2 == 0 else -4.0)
        xy[i, 1] += rng.uniform(-1, 1)
    feats = build_scene_features(
        xy, np.full(N, 0.6, np.float32), np.zeros(N, np.float32),
        np.full(N, 7.0, np.float32), np.ones(N, bool), CFG.landmarks)
    ov = jnp.ones(N, bool)
    store = init_store(CFG.landmarks)
    rec = jax.jit(lambda s, o, p, y: record_tick(s, o, p, y, CFG.camera,
                                                 CFG.landmarks))
    for i, x in enumerate(np.arange(0.0, 40.0, 0.5)):
        obs = observe(jnp.array([x, 0.0, 0.5]), jnp.float32(0.0), feats, ov,
                      jax.random.PRNGKey(i), CFG.camera, CFG.landmarks)
        cam_p, _ = camera_pose(jnp.array([x, 0.0, 0.5]), jnp.float32(0.0),
                               CFG.camera)
        store = rec(store, obs, cam_p, jnp.float32(0.0))
    assert int(store.count) >= 8
    return feats, ov, store


# (true pose, query pose, yaw): on the strip, off it, and far away
QUERIES = [((20.4, 0.3), (22.0, 1.0), 0.0), ((10.2, -0.4), (10.0, 0.0), 0.0),
           ((30.0, 0.5), (29.5, 0.2), 0.1), ((5.0, 0.0), (5.5, 0.0), 0.0),
           ((14.0, 0.2), (14.3, -0.1), -0.05), ((60.0, 9.0), (60.0, 9.0), 0.0),
           ((18.0, 0.0), (18.0, 0.0), 3.0)]


@pytest.mark.parametrize("no_bias", [False, True])
def test_match_tick_matches_jax(strip_store, no_bias):
    feats, ov, store = strip_store
    lcfg, tlcfg = CFG.landmarks, TDEFAULT.landmarks
    if no_bias:
        # the geometric solver alone, as tests/test_landmarks.py checks it
        kw = dict(anchor_bias_median_m=0.0, session_dead_frac=0.0)
        lcfg = dataclasses.replace(lcfg, **kw)
        tlcfg = dataclasses.replace(tlcfg, **kw)
    match = jax.jit(lambda s, o, v, h, p, k: match_tick(
        s, o, v, h, p, k, CFG.camera, lcfg))
    jres, obss, qs, hs, keys = [], [], [], [], []
    for i, (true_xy, q_xy, yaw) in enumerate(QUERIES):
        obs = observe(jnp.array([*true_xy, 0.5]), jnp.float32(yaw), feats,
                      ov, jax.random.PRNGKey(99 + i), CFG.camera,
                      CFG.landmarks)
        key = jax.random.PRNGKey(7 + i)
        q = jnp.array(q_xy, jnp.float32)
        jres.append(match(store, obs, q, jnp.float32(yaw),
                          jnp.array([*q_xy, 0.5]), key))
        obss.append(obs)
        qs.append(np.asarray(q))
        hs.append(np.float32(yaw))
        keys.append(np.asarray(key))
    B = len(QUERIES)
    tstore = _stack([store] * B)
    tres = tm.match_tick(tstore, _stack(obss), torch.from_numpy(np.stack(qs)),
                         torch.from_numpy(np.stack(hs)),
                         torch.zeros(B, 3),
                         torch.from_numpy(np.stack(keys).astype(np.int64)),
                         TDEFAULT.camera, tlcfg)
    for i, jr in enumerate(jres):
        assert bool(tres.ok[i]) == bool(jr.ok), i
        assert int(tres.reason[i]) == int(jr.reason), i
        assert int(tres.n_inliers[i]) == int(jr.n_inliers), i
        np.testing.assert_allclose(tres.xy[i].numpy(), np.asarray(jr.xy),
                                   atol=1e-3)
        np.testing.assert_allclose(float(tres.std[i]), float(jr.std),
                                   atol=1e-6)
    reasons = {int(r.reason) for r in jres}
    assert tm.R_PUBLISHED in reasons and tm.R_NO_CANDIDATES in reasons


def case_args(path):
    """``match_tick``'s JAX inputs from a case file: (store, obs, vio_xy,
    vio_heading, base_pos_vio, key, consistency_extra_m)."""
    with np.load(path) as z:
        c = dict(z)
    store = LandmarkStore(*(jnp.asarray(c[f"store_{f}"])
                            for f in LandmarkStore._fields))
    obs = Observation(*(jnp.asarray(c[f"obs_{f}"])
                        for f in Observation._fields))
    return (store, obs, *(jnp.asarray(c[k]) for k in
                          ("xy", "yaw", "query", "key", "extra")))


def test_divergence_probe_holds_the_matcher_to_compiled_jax():
    """``tools/torch_divergence_probe.py`` holds the port's ``match_tick``
    on JAX's inputs against JAX's compiled matcher, which the JAX package's
    rollouts run, or else against the same JAX code run op by op
    (``matcher_compare``).  At ``09_se_ne``'s rgbd tick 150 JAX's matcher
    run op by op parts from its compiled self by 0.5 mm and 2.7e-3 px (the
    Horn power iteration is ill-conditioned there), beyond the probe's
    ``STEP_ATOL``.  The port sums its 4 x 4 algebra in the order of JAX's
    unrolled sums, one rounding a product, as the op-by-op run does (the
    compiled code fuses multiply-adds): it gives that run's median
    reprojection to the bit and its anchor within 2e-6 m, and the probe
    holds it there."""
    args = case_args(CASE)
    cj, ct = jbase.rgbd_no_imu(), tbase.rgbd_no_imu()
    compiled = probe.compiled_match_tick(cj.camera, cj.landmarks)(*args)
    eager = match_tick(*args[:6], cj.camera, cj.landmarks,
                       consistency_extra_m=args[6])
    assert bool(compiled.ok) and int(compiled.n_inliers) == 53
    b1 = probe.batch1
    port = tm.match_tick(*(b1(a) for a in args[:6]), ct.camera, ct.landmarks,
                         consistency_extra_m=b1(args[6]))
    assert not probe.held(probe.compare(
        jax.tree_util.tree_map(np.asarray, eager), compiled))
    assert not probe.held(probe.compare(probe.row0(port), compiled))
    assert probe.held(probe.compare(probe.row0(port), eager))
    assert float(port.reproj[0]) == float(eager.reproj)
    np.testing.assert_allclose(port.xy[0].numpy(), np.asarray(eager.xy),
                               atol=2e-6)
    parts = probe.matcher_compare(probe.row0(port), compiled,
                                  probe.jmat_eager(cj)(*args))
    assert probe.held(parts)
    assert {v["reference"] for v in parts.values()} == {"eager"}


def test_matcher_parts_from_jax_only_at_kabsch_start_ties():
    """At ``12_ne_mid``'s rgbd tick 45 the probe's matcher check fails
    with JAX compiled and run op by op agreeing (70 inliers) and the port
    at 76: on match_tick's own candidates, every RANSAC hypothesis whose
    rotation or inlier count differs is one where Horn's four
    power-iteration starts tie within float32's rounding of their Rayleigh
    quotients (float64 values 2e-8 to 2e-7 apart, relative; the bound
    2^-20), and JAX keeps one start, the port another; each rotation is its
    start's float64 result.  The port sums the 4 x 4 algebra in JAX's
    order; its point sums (the centroids, the cross-covariance) are a fixed
    tree, XLA's a dot, and one ulp there decides such a tie.  The reference
    tie the RGB-D SLAM baseline shows (``chip_smoke.kabsch_ties``), here in
    the anchor matcher: not a stage of the port computing otherwise."""
    args = case_args(TIE_CASE)
    store, obs, xy, yaw, _, key, extra = args
    cj, ct = jbase.rgbd_no_imu(), tbase.rgbd_no_imu()
    compiled = probe.compiled_match_tick(cj.camera, cj.landmarks)(
        store, obs, xy, yaw, jnp.zeros(3), key, extra)
    b1 = probe.batch1
    port = tm.match_tick(b1(store), b1(obs), b1(xy), b1(yaw),
                         torch.zeros(1, 3), b1(key), ct.camera, ct.landmarks,
                         consistency_extra_m=b1(extra))
    assert (int(compiled.n_inliers), int(port.n_inliers[0])) == (70, 76)

    # every valid hypothesis whose rotation or inlier count differs: two
    # different starts' float64 results, their Rayleigh quotients within
    # float32's rounding of a 16-term sum (probe.START_TIE_REL, 2^-20)
    ties = probe.matcher_start_ties(args, cj)
    assert ties["not_ties"] == [] and ties["ties"] >= 2, ties
    # so the divergence probe reads the tick as a tie, not a fault
    parts = probe.matcher_compare(
        probe.row0(port), compiled, probe.jmat_eager(cj)(*args),
        lambda: ties)
    assert probe.held(parts)
    assert {v["reference"] for v in parts.values()} == {"start_tie"}
