"""The RGB-D SLAM baseline (``datasets/slam/rgbd_slam.py``) against the JAX
package's, on the loop session of ``tests/test_rgbd_slam.py`` (72 pillars
on a ring, 140 frames: a closed loop plus a revisit), the session built by
each package's own ``observe`` from the same threefry keys.

Tolerances.  The observations are the same (feature ids and descriptors
equal, points within 1e-5 m), the signatures within 1e-7, the loop set —
candidate pairs and accepted flags — equal, the open and optimized poses
within 0.02 m.  The per-frame inlier counts are equal except where float32
cannot decide them: ``_kabsch`` takes the dominant eigenvector of Horn's
matrix by 24 power-iteration steps from four starts and keeps the start
with the largest Rayleigh quotient.  ``chip_smoke.kabsch_ties`` redoes both
Kabsch solves of each pair in float64 and keeps every start whose quotient
is within 2**-20 of the best (the rounding of a float32 Horn matrix summed
over up to 256 points); on this session 20 of the 139 pairs have tied
starts that give different counts.  Every count of both packages is a tied
start's, with its pose within 1e-5 of that start's float64 pose (2.6e-6 at
most); a count may differ from JAX's only where both are tied starts', by
one inlier, on at most a tenth of the pairs.  The JAX package itself flips
there: its eager and jitted runs of ``frame_rel_pose`` differ on such
pairs.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(Path(__file__).parent))
import chip_smoke  # noqa: E402
from test_rgbd_slam import CFG, _loop_session  # noqa: E402

from nclt_slam_tpu.datasets.slam import rgbd_slam as jrs  # noqa: E402
from nclt_slam_tpu_torch import interop  # noqa: E402
from nclt_slam_tpu_torch.datasets.slam import rgbd_slam as trs  # noqa: E402
from nclt_slam_tpu_torch.eval.metrics import ate_rmse  # noqa: E402

POSE_ATOL_M = 0.02
SIG_ATOL = 1e-7
OBS_ATOL_M = 1e-5
MAX_FLIP_SHARE = chip_smoke.RGBD_SLAM_MAX_FLIP_SHARE


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def session():
    jobs, gt = _loop_session()
    tobs, tgt = chip_smoke.rgbd_loop_session("cpu")
    jst = jax.tree_util.tree_map(lambda *x: np.stack([np.asarray(a)
                                                      for a in x]), *jobs)
    kw = chip_smoke.RGBD_SLAM_KW
    jres = jrs.run_rgbd_slam(jobs, CFG.camera, **kw)
    tres = trs.run_rgbd_slam(tobs, CFG.camera, **kw)
    return jobs, jst, gt, tobs, tgt, jres, tres


@pytest.fixture(scope="module")
def jax_frames(session):
    """JAX's observations as the port's tensors, and their Kabsch ties."""
    obs = interop.from_numpy_tree(session[1], "cpu")
    return obs, chip_smoke.kabsch_ties(obs, CFG.camera)


def test_port_session_observes_what_jax_does(session):
    _, jst, gt, tobs, tgt, *_ = session
    np.testing.assert_array_equal(tgt, gt)
    assert np.array_equal(tobs.feat_id.numpy(), jst.feat_id)
    assert np.array_equal(tobs.valid.numpy(), jst.valid)
    assert np.array_equal(tobs.desc.numpy(), jst.desc.astype(np.int64))
    np.testing.assert_allclose(tobs.p3d_cam.numpy(), jst.p3d_cam,
                               atol=OBS_ATOL_M)


def test_frame_signature_matches_jax(session):
    jobs, _, _, tobs, *_ = session
    want = np.stack([np.asarray(jrs.frame_signature(o)) for o in jobs[::7]])
    got = trs.frame_signature(trs._frames(tobs, range(0, 140, 7))).numpy()
    np.testing.assert_allclose(got, want, atol=SIG_ATOL)
    # the JAX test's property: an adjacent frame is nearer than the far side
    s = trs.frame_signature(trs._frames(tobs, [0, 1, 40])).numpy()
    assert np.abs(s[0] - s[1]).mean() < np.abs(s[0] - s[2]).mean()


def test_run_rgbd_slam_matches_jax(session, jax_frames):
    *_, tobs, _, jres, tres = session
    for got, want in zip(tres.loops, jres.loops):
        assert np.array_equal(got, np.asarray(want))
    assert int(tres.loops[2].sum()) >= 1
    port_ties = [{o[0] for o in x}
                 for x in chip_smoke.kabsch_ties(tobs, CFG.camera)]
    jax_ties = [{o[0] for o in x} for x in jax_frames[1]]
    for k in range(1, len(tres.n_matches)):
        assert int(tres.n_matches[k]) in port_ties[k - 1], k
        assert int(jres.n_matches[k]) in jax_ties[k - 1], k
    flips = np.flatnonzero(tres.n_matches != jres.n_matches)
    assert len(flips) <= MAX_FLIP_SHARE * (len(tres.n_matches) - 1), flips
    for k in flips:
        assert abs(int(tres.n_matches[k]) - int(jres.n_matches[k])) <= 1, k
        assert int(jres.n_matches[k]) in port_ties[k - 1], k
    np.testing.assert_allclose(tres.poses_open, jres.poses_open,
                               atol=POSE_ATOL_M)
    np.testing.assert_allclose(tres.poses_opt, jres.poses_opt,
                               atol=POSE_ATOL_M)


def test_loop_closure_reduces_ate(session):
    """The JAX test's own assertions, on the port's run."""
    _, _, gt, _, _, _, res = session
    assert (res.n_matches[1:] >= 8).mean() > 0.9
    ate_open = ate_rmse(res.poses_open[:, :2], gt)
    ate_opt = ate_rmse(res.poses_opt[:, :2], gt)
    assert np.isfinite(ate_opt)
    assert ate_opt <= ate_open * 1.05 + 0.02, (ate_open, ate_opt)
    assert ate_opt < 5.0, ate_opt


def test_batched_frame_rel_pose_equals_one_pair_at_a_time(session):
    """The odometry's one batched call gives each pair what a call of that
    pair alone gives, bit for bit on the CPU."""
    *_, tobs, _, _, _ = session
    pairs = [(0, 1), (35, 36), (76, 77), (12, 100)]
    a = trs._frames(tobs, [i for i, _ in pairs])
    b = trs._frames(tobs, [j for _, j in pairs])
    batched = trs.frame_rel_pose(a, b, CFG.camera)
    for p, (i, j) in enumerate(pairs):
        one = trs.frame_rel_pose(trs._frames(tobs, [i]),
                                 trs._frames(tobs, [j]), CFG.camera)
        for x, y in zip(batched, one):
            assert torch.equal(x[p:p + 1], y), (i, j)


def test_frame_rel_pose_on_jax_frames_matches_jax(session, jax_frames):
    """``frame_rel_pose`` of both packages on JAX's own observations of all
    139 odometry pairs: each result a tied Kabsch start's (its count, its
    pose within ``KABSCH_TIE_POSE_ATOL`` of the start's float64 pose), the
    counts equal but on tied pairs, there by one inlier, and the flags
    equal wherever the counts are."""
    jobs = session[0]
    obs, ties = jax_frames
    f = jax.jit(lambda a, b: jrs.frame_rel_pose(a, b, CFG.camera))
    T = len(jobs)
    got = trs.frame_rel_pose(trs._frames(obs, range(T - 1)),
                             trs._frames(obs, range(1, T)), CFG.camera)
    flips = 0
    for p in range(T - 1):
        want = [np.asarray(x) for x in f(jobs[p], jobs[p + 1])]
        mine = [x[p].numpy() for x in got]
        for r in (mine, want):
            assert chip_smoke.tie_witnessed(ties[p], r[3], r[:3]), (p, r)
        dn = abs(int(mine[3]) - int(want[3]))
        assert dn <= 1, p
        flips += dn
        if not dn:
            assert bool(mine[4]) == bool(want[4]), p
    assert flips <= MAX_FLIP_SHARE * (T - 1)
