"""The port's anchor matcher against the JAX package on the CPU: the Horn
/ power-iteration Kabsch, and ``match_tick`` on the forest strip of
``tests/test_landmarks.py`` for a batch of query poses.

Tolerances.  ``_kabsch`` reduces its 4x4 products in another order than
the JAX package's unrolled scalar sums: R and t agree to 1e-5.  The RANSAC
samples are bit-exact (threefry ``randint``), so every discrete outcome of
``match_tick`` (published, reason, inlier count) is equal and the anchor
position agrees to 1e-3 m.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nclt_slam_tpu.config import DEFAULT
from nclt_slam_tpu.landmarks import init_store, match_tick, record_tick
from nclt_slam_tpu.landmarks.matcher import _kabsch as j_kabsch
from nclt_slam_tpu.sensors.depth import camera_pose
from nclt_slam_tpu.sensors.features import build_scene_features, observe
from nclt_slam_tpu_torch import interop
from nclt_slam_tpu_torch.config import DEFAULT as TDEFAULT
from nclt_slam_tpu_torch.landmarks import matcher as tm

# the test workers share the CPU: one intra-op thread each keeps their
# torch thread pools from oversubscribing it
torch.set_num_threads(1)

CFG = DEFAULT


def _stack(trees):
    return interop.from_numpy_tree(jax.tree_util.tree_map(
        lambda *xs: np.stack([np.asarray(x) for x in xs]), *trees))


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
