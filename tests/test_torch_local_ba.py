"""``local_ba`` — the sliding-window BA write-back on the keyframe ring —
in the port against the JAX package's ``vio/tracker.py:local_ba``, on the
same ``VioState``.

The state comes from a miniature RGB-D repeat of the port (70 ticks off the
route's own waypoints, an empty teach map and store: the ring then holds
seven keyframes); it is carried into the JAX package as numpy and back
(``tests/test_torch_rgbd_slice.py`` round-trips a state the JAX rollout
produced).  The JAX side solves each route's window with its XLA
``solve_ba`` under ``vmap``; the port builds the batched problem and solves
it with ``solve_ba`` (its plain version here, on the CPU).

Tolerance: keyframes within 1e-4 m and 1e-5 in the quaternion, map points
within 1e-3 m (the two solvers' own agreement after three iterations), and
the same routes accepted and the same map rows written.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from test_rollout_e2e import pack_test_route, straight_route, tiny_scene  # noqa: E402
from test_torch_ours_slice import batch1, configs  # noqa: E402

from nclt_slam_tpu.vio import tracker as jtracker  # noqa: E402
from nclt_slam_tpu_torch import interop  # noqa: E402
from nclt_slam_tpu_torch.baselines import configs as tbase  # noqa: E402
from nclt_slam_tpu_torch.landmarks.store import init_store  # noqa: E402
from nclt_slam_tpu_torch.rollout.repeat import run_repeat as t_run_repeat  # noqa: E402
from nclt_slam_tpu_torch.vio import tracker as ttracker  # noqa: E402

torch.set_num_threads(1)

REPEAT_TICKS = 70
KF_ATOL_M = 1e-4
QUAT_ATOL = 1e-5
MAP_ATOL_M = 1e-3


@pytest.fixture(scope="module")
def state():
    """(port VioState of two routes, JAX configs): route 0 as it drove,
    route 1 the same ring with tracking lost."""
    jt_cfg, _, jr_cfg, tr_cfg = configs()
    preset = tbase.rgbd_no_imu()
    cfg = tr_cfg.replace(
        mode=preset.mode,
        fusion=dataclasses.replace(tr_cfg.fusion, align_window=20))
    packed, wps, n_wps = pack_test_route(straight_route(), jt_cfg)
    routes = batch1(packed)
    grid = torch.zeros(1, cfg.map.rows, cfg.map.cols, dtype=torch.int32)
    rep = t_run_repeat(batch1(tiny_scene(drop_on_path=True)), routes, grid,
                       torch.from_numpy(np.asarray(wps))[None],
                       torch.tensor([n_wps], dtype=torch.int32), cfg,
                       REPEAT_TICKS,
                       store=init_store(cfg.landmarks, 1, "cpu"))
    vio = rep.final.vio
    assert int(vio.kf_valid.sum()) >= 5 and not bool(vio.lost[0])
    two = type(vio)(*(torch.cat([x, x]) for x in vio))
    two = two._replace(lost=torch.tensor([False, True]))
    return two, jr_cfg, tr_cfg


def to_jax(tstate):
    return jtracker.VioState(*(jnp.asarray(x)
                               for x in interop.to_numpy_tree(tstate)))


@pytest.fixture(scope="module")
def j_local_ba(state):
    _, jr_cfg, _ = state
    return jax.jit(jax.vmap(
        lambda v: jtracker.local_ba(v, jr_cfg.camera, jr_cfg.vio)))


def _compare(tstate, tnew, jnew):
    np.testing.assert_allclose(tnew.kf_pos.numpy(), jnew.kf_pos,
                               atol=KF_ATOL_M)
    np.testing.assert_allclose(tnew.kf_quat.numpy(), jnew.kf_quat,
                               atol=QUAT_ATOL)
    np.testing.assert_allclose(tnew.map_xyz.numpy(), jnew.map_xyz,
                               atol=MAP_ATOL_M)
    # the same routes pass `enough` (their ring moved) and the same map
    # rows are written back
    old = interop.to_numpy_tree(tstate)
    moved_t = (tnew.kf_pos.numpy() != old.kf_pos).any((1, 2))
    moved_j = (np.asarray(jnew.kf_pos) != old.kf_pos).any((1, 2))
    assert np.array_equal(moved_t, moved_j)
    rows_t = (tnew.map_xyz.numpy() != old.map_xyz).any(-1)
    rows_j = (np.asarray(jnew.map_xyz) != old.map_xyz).any(-1)
    assert np.array_equal(rows_t, rows_j)
    # nothing else of the state is touched
    for f in tstate._fields:
        if f not in ("kf_pos", "kf_quat", "map_xyz"):
            assert torch.equal(getattr(tnew, f), getattr(tstate, f)), f
    return moved_t, rows_t


def test_state_carries_into_jax_and_back(state):
    tstate, *_ = state
    back = interop.from_numpy_tree(
        jax.tree_util.tree_map(np.asarray, to_jax(tstate)), "cpu")
    for a, b in zip(back, tstate):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_local_ba_matches_jax(state, j_local_ba):
    tstate, _, tr_cfg = state
    tnew = ttracker.local_ba(tstate, tr_cfg.camera, tr_cfg.vio)
    moved, rows = _compare(tstate, tnew, j_local_ba(to_jax(tstate)))
    # route 0 is accepted and writes points back; the lost route keeps its
    # ring and its map
    assert moved.tolist() == [True, False]
    assert rows[0].sum() >= 20 and rows[1].sum() == 0
    # the trust region: no keyframe moves further than TRUST_M
    step = (tnew.kf_pos - tstate.kf_pos).norm(dim=-1).max().item()
    assert 0 < step <= ttracker.TRUST_M + 1e-6


def test_local_ba_duplicate_slots_and_gates(state, j_local_ba):
    """Slot ids repeat in the newest keyframe's row (unmatched observations
    carry their nearest slot): the write-back's last row wins, as in the
    JAX package's scatter on the CPU.  Route 1 now has too few keyframes."""
    tstate, _, tr_cfg = state
    K = tstate.kf_pos.shape[1]
    newest = int((tstate.kf_ptr[0] - 1) % K)
    slots = tstate.kf_obs_slot.clone()
    valid = tstate.kf_obs_valid.clone()
    # rows 3 and 150 share a slot, one observed and one not; rows 10..13
    # repeat row 9 (slot and measurement: the window stays consistent, so
    # the two packages' solvers can be held together by tolerance)
    slots[:, newest, 150] = slots[:, newest, 3]
    valid[:, newest, 150] = False
    uv, z = tstate.kf_obs_uv.clone(), tstate.kf_obs_z.clone()
    slots[:, newest, 10:14] = slots[:, newest, 9:10]
    valid[:, newest, 10:14] = valid[:, newest, 9:10]
    uv[:, newest, 10:14] = uv[:, newest, 9:10]
    z[:, newest, 10:14] = z[:, newest, 9:10]
    kf_valid = tstate.kf_valid.clone()
    kf_valid[1] = False
    kf_valid[1, newest] = True
    synth = tstate._replace(kf_obs_slot=slots, kf_obs_valid=valid,
                            kf_obs_uv=uv, kf_obs_z=z, kf_valid=kf_valid,
                            lost=torch.tensor([False, False]))
    tnew = ttracker.local_ba(synth, tr_cfg.camera, tr_cfg.vio)
    moved, rows = _compare(synth, tnew, j_local_ba(to_jax(synth)))
    assert moved.tolist() == [True, False]
    assert rows[1].sum() == 0


def test_local_ba_picks_the_first_matching_observation():
    """Two valid observations of one keyframe name the same slot: the
    window takes the first (``argmax`` over the match mask in the JAX
    package), and a keyframe without a match gets weight zero."""
    K, S = 4, ttracker.KF_OBS
    st = ttracker.init_vio(8, K, 1, "cpu")
    slot = torch.arange(S, dtype=torch.int32).repeat(1, K, 1)
    slot[0, 1, 7] = 5                       # keyframe 1 sees slot 5 twice
    uv = torch.arange(K * S * 2, dtype=torch.float32).reshape(1, K, S, 2)
    valid = torch.ones(1, K, S, dtype=torch.bool)
    valid[0, 2, 5] = False                  # keyframe 2 does not see slot 5
    st = st._replace(kf_obs_slot=slot, kf_obs_uv=uv, kf_obs_valid=valid,
                     kf_valid=torch.ones(1, K, dtype=torch.bool),
                     kf_ptr=torch.tensor([K], dtype=torch.int32))
    seen = {}

    def spy(prob, cam, cfg, iters=None, site="other"):
        seen["prob"] = prob
        return ba.BAResult(prob.kf_pos, prob.kf_quat, prob.points,
                           torch.zeros(1))

    from nclt_slam_tpu_torch.config import DEFAULT
    from nclt_slam_tpu_torch.vio import ba
    orig, ba.solve_ba = ba.solve_ba, spy
    try:
        ttracker.local_ba(st, DEFAULT.camera, DEFAULT.vio)
    finally:
        ba.solve_ba = orig
    prob = seen["prob"]
    assert prob.obs_w.shape == (1, K, S) and prob.pt_prior_w.shape == (1, S)
    assert torch.equal(prob.obs_uv[0, 1, 5], uv[0, 1, 5])   # not row 7
    assert prob.obs_w[0, 2, 5] == 0 and prob.obs_w[0, 1, 5] == 1
    assert float(prob.w_rel) == 10.0
