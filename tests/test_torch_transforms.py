"""The point-cloud augmentation pipeline (``datasets/transforms.py``)
against the JAX package, from the same seeded inputs and the same keys.

Masks are bit-equal (the uniform draws are bit-exact, the subsample's rank
a stable sort, the voxel hash int32 with wrapping products).  Points are
held by tolerance: a rotation's sin/cos and its 3x3 product round
differently in XLA and torch (~1 ulp of 10 m, bound 1e-5 m), and a normal
draw is within four ulps of JAX's (``tests/test_torch_prng.py``), so the
jitter is bound by 1e-6 m.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nclt_slam_tpu.datasets import transforms as J
from nclt_slam_tpu_torch.core import prng
from nclt_slam_tpu_torch.datasets import transforms as T

torch.set_num_threads(1)

POINT_ATOL = 1e-5
JITTER_ATOL = 1e-6
CONFIG = {
    "point_cloud": {"remove_ground": True, "ground_threshold": -9.0,
                    "voxel_size": 0.5, "max_points": 64},
    "augmentation": {"random_rotation": True, "rotation_range": 45.0,
                     "random_flip": True, "jitter": 0.01},
}


def keys(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed, "cpu")


def cloud(n=512, c=4, live=0.9, seed=0, span=10.0):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-span, span, (n, c)).astype(np.float32)
    mask = rng.rand(n) < live
    return pts, mask


def run_both(jfn, tfn, seed, pts, mask):
    jk, tk = keys(seed)
    jp, jm = jfn(jk, jnp.asarray(pts), jnp.asarray(mask))
    tp, tm = tfn(tk, torch.from_numpy(pts), torch.from_numpy(mask))
    return np.asarray(jp), np.asarray(jm), tp.numpy(), tm.numpy()


@pytest.mark.parametrize("name, kw, atol", [
    ("random_rotation", {}, POINT_ATOL),
    ("random_rotation", {"max_angle_deg": 30.0}, POINT_ATOL),
    ("random_flip", {}, 0.0),
    ("random_flip", {"prob": 1.0}, 0.0),
    ("random_jitter", {}, JITTER_ATOL),
    ("random_jitter", {"sigma": 0.5, "clip": 0.05}, JITTER_ATOL),
    ("normalize", {}, POINT_ATOL),
    ("normalize", {"scale": True}, POINT_ATOL),
    ("remove_ground", {"threshold": 0.0}, 0.0),
])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_stage_matches_jax(name, kw, atol, seed):
    pts, mask = cloud(seed=seed)
    jp, jm, tp, tm = run_both(lambda k, p, m: getattr(J, name)(k, p, m, **kw),
                              lambda k, p, m: getattr(T, name)(k, p, m, **kw),
                              seed, pts, mask)
    assert np.array_equal(tm, jm)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=atol)
    np.testing.assert_array_equal(tp[:, 3], pts[:, 3])   # extra channel


def test_subsample_with_tied_scores_is_bit_equal():
    """20,000 points: float32 uniforms have 2**23 values, so some live
    points tie.  With the cut placed inside a tie, only a stable rank keeps
    JAX's subset (the lower index); 4096 points as the pipeline keeps."""
    pts, mask = cloud(n=20000, c=3, live=0.95, seed=3)
    for seed in range(4):
        score = prng.uniform(prng.PRNGKey(seed, "cpu"), (20000,)).numpy()
        live = np.where(mask, score, np.inf)
        vals, counts = np.unique(score[mask], return_counts=True)
        assert (counts > 1).any(), "no tie to test"
        tie = vals[counts > 1][0]
        cut = int((live < tie).sum()) + 1     # keeps one of the tied points
        for num in (cut, 4096):
            jp, jm, tp, tm = run_both(
                lambda k, p, m: J.random_subsample(k, p, m, num_points=num),
                lambda k, p, m: T.random_subsample(k, p, m, num_points=num),
                seed, pts, mask)
            assert tm.sum() == num
            assert np.array_equal(tm, jm)
            if num == cut:
                kept = tm[live == tie]
                assert kept[0] and not kept[1:].any()


@pytest.mark.parametrize("voxel, span", [(5.0, 10.0), (0.1, 10.0),
                                         (0.01, 500.0)])
def test_voxel_hash_matches_jax(voxel, span):
    """Below 1 m the hash's int32 products wrap (at 1 cm over 500 m by
    many turns), voxel ids are negative, and % must stay a floor modulo."""
    pts, mask = cloud(n=4000, c=3, seed=5, span=span)
    v = np.floor(pts / voxel).astype(np.int64)
    wraps = np.abs(v * np.array([73856093, 19349663, 83492791])) >= 2 ** 31
    assert wraps.any() == (voxel < 1.0)
    jp, jm, tp, tm = run_both(
        lambda k, p, m: J.voxel_downsample(k, p, m, voxel_size=voxel),
        lambda k, p, m: T.voxel_downsample(k, p, m, voxel_size=voxel),
        0, pts, mask)
    assert 0 < tm.sum() <= mask.sum()
    assert np.array_equal(tm, jm)


@pytest.mark.parametrize("is_train", [True, False])
def test_build_transforms_matches_jax(is_train):
    pts, mask = cloud(seed=2)
    jpipe = J.build_transforms(CONFIG, is_train=is_train)
    tpipe = T.build_transforms(CONFIG, is_train=is_train)
    jp, jm, tp, tm = run_both(jpipe, tpipe, 11, pts, mask)
    assert tm.sum() == 64
    assert np.array_equal(tm, jm)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=POINT_ATOL)


def test_compose_splits_keys_as_jax():
    pts, mask = cloud(seed=4)
    stages = ((J.random_rotation, J.random_jitter, J.random_subsample),
              (T.random_rotation, T.random_jitter, T.random_subsample))
    jp, jm, tp, tm = run_both(J.compose(*stages[0]), T.compose(*stages[1]),
                              5, pts, mask)
    assert np.array_equal(tm, jm)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=POINT_ATOL)
    # no stage: the key is still split once, the points pass through
    jp, jm, tp, tm = run_both(J.compose(), T.compose(), 5, pts, mask)
    assert np.array_equal(tp, pts) and np.array_equal(tm, mask)


def test_apply_batch_matches_jax_vmap():
    """One batched call of the port against ``jax.vmap`` of the pipeline
    over the split keys."""
    scans = [cloud(seed=s) for s in range(6)]
    pts = np.stack([p for p, _ in scans]) + np.arange(6, dtype=np.float32
                                                      )[:, None, None]
    mask = np.stack([m for _, m in scans])
    jpipe = J.build_transforms(CONFIG, is_train=True)
    tpipe = T.build_transforms(CONFIG, is_train=True)
    jk, tk = keys(9)
    jp, jm = jax.jit(lambda k, p, m: J.apply_batch(jpipe, k, p, m))(
        jk, jnp.asarray(pts), jnp.asarray(mask))
    tp, tm = T.apply_batch(tpipe, tk, torch.from_numpy(pts),
                           torch.from_numpy(mask))
    assert tp.shape == pts.shape
    assert (tm.sum(1) == 64).all()
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                               atol=POINT_ATOL)
    # each row is the single-scan pipeline on its own split key
    for b in (0, 5):
        p1, m1 = tpipe(prng.split(tk, 6)[b], torch.from_numpy(pts[b]),
                       torch.from_numpy(mask[b]))
        assert torch.equal(m1, tm[b]) and torch.equal(p1, tp[b])
