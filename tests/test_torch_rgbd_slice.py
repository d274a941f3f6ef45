"""The RGB-D slice — the ``rgbd`` and ``rgbd_ba`` repeat modes (VIO without
the inertial term, anchors on, the baselines' GT-stall watchdog, and the
sliding-window local BA every tenth tick) — against the JAX package's
``repeat_step`` from the same seed, on the miniature scene/route/config of
``tests/test_rollout_e2e.py`` with two routes in the batch.

Route 0 is the ours slice's route.  Route 1 drives the same route in a scene
without a single valid feature: its VIO never initializes, its relay never
commits, the bring-up hold parks it at spawn, and the watchdog (window and
warm-up cut to ``STALL_WINDOW`` / ``STALL_WARMUP`` ticks, since the real
warm-up of 2400 ticks cannot pass in a short run) ends its run.  The relay's
alignment window is cut to 20 samples so that route 0 drives from tick 19,
fills its keyframe ring and has six local-BA solves accepted (ticks 43..93)
inside the window; it reaches the last of its three waypoints at tick 90.

One JAX program serves both modes: ``local_ba`` leaves a route's state
untouched while its ring holds fewer than three keyframes (until tick
``FIRST_BA``), so up to there the JAX ``rgbd_ba`` run *is* the JAX ``rgbd``
run, and the port's ``rgbd`` configuration (no BA branch) is held against
it over those ticks.

Tolerance: every discrete sequence equal and the poses within 1e-3 m over
the whole window (no visibility gate flips inside it: the first, an
anchor's inlier count, comes at tick 105); the keyframe ring and the VIO
map after six accepted solves within 2e-3 m (each solve amplifies the
1e-5 m rounding differences of its inputs).
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
from test_torch_ours_slice import DISCRETE, POSE_ATOL, batch1, configs  # noqa: E402

from nclt_slam_tpu.baselines import configs as jbase  # noqa: E402
from nclt_slam_tpu.rollout import campaign as jcamp  # noqa: E402
from nclt_slam_tpu.rollout.repeat import init_repeat_carry  # noqa: E402
from nclt_slam_tpu.rollout.repeat import repeat_step as j_repeat_step  # noqa: E402
from nclt_slam_tpu.vio import tracker as jtracker  # noqa: E402
from nclt_slam_tpu_torch import interop  # noqa: E402
from nclt_slam_tpu_torch.baselines import configs as tbase  # noqa: E402
from nclt_slam_tpu_torch.rollout import campaign as tcamp  # noqa: E402
from nclt_slam_tpu_torch.rollout.repeat import run_repeat as t_run_repeat  # noqa: E402
from nclt_slam_tpu_torch.rollout.teach import run_teach as t_run_teach  # noqa: E402
from nclt_slam_tpu_torch.vio import tracker as ttracker  # noqa: E402

torch.set_num_threads(1)

TEACH_TICKS = 100
REPEAT_TICKS = 94      # ends with the solve of tick 93, the sixth accepted
STALL_WINDOW = 36     # ticks: a ring period of 2
STALL_WARMUP = 60
STALL_MIN_M = 0.2
ALIGN_WINDOW = 20
FIRST_BA = 43         # route 0's first local-BA tick with three keyframes
BA_STATE_ATOL = 2e-3


def slice_configs():
    """(JAX teach, port teach, JAX rgbd_ba, port rgbd_ba, port rgbd)."""
    jt, tt, jr, tr = configs()

    def cut(base, preset):
        return base.replace(
            mode=preset.mode, vio=preset.vio,
            fusion=dataclasses.replace(base.fusion, align_window=ALIGN_WINDOW),
            planner=dataclasses.replace(
                base.planner, gt_stall_abort=preset.planner.gt_stall_abort,
                gt_stall_window_ticks=STALL_WINDOW,
                gt_stall_warmup_ticks=STALL_WARMUP,
                gt_stall_min_m=STALL_MIN_M))

    j_ba = cut(jr, jbase.rgbd_no_imu())
    j_ba = j_ba.replace(vio=dataclasses.replace(j_ba.vio,
                                                enable_local_ba=True))
    t_ba = cut(tr, tbase.rgbd_ba())
    t_rgbd = cut(tr, tbase.rgbd_no_imu())
    assert dataclasses.asdict(t_ba) == dataclasses.asdict(j_ba)
    assert t_ba.planner.gt_stall_abort and not t_ba.mode.use_imu
    assert not t_rgbd.vio.enable_local_ba
    return jt, tt, j_ba, t_ba, t_rgbd


def stack2(a, b):
    return jax.tree_util.tree_map(lambda x, y: np.stack(
        [np.asarray(x), np.asarray(y)]), a, b)


@pytest.fixture(scope="module")
def runs():
    jt_cfg, tt_cfg, j_cfg, t_cfg, t_rgbd_cfg = slice_configs()
    packed, _, _ = pack_test_route(straight_route(), jt_cfg)
    teach = t_run_teach(batch1(tiny_scene(drop_on_path=False)),
                        batch1(packed), tt_cfg, TEACH_TICKS)
    trace_np = interop.to_numpy_tree(teach.trace)
    jdata = jcamp.CampaignData(None, None, jax.tree_util.tree_map(
        lambda x: np.asarray(x)[None], packed), ("straight",))
    jw, jn = jcamp.teach_waypoints(
        jdata, teach._replace(trace=trace_np), j_cfg, source="vio")
    wps, n_wps = np.asarray(jw)[0], int(np.asarray(jn)[0])

    scene = tiny_scene(drop_on_path=True)
    blind = scene._replace(feat_valid=jnp.zeros_like(scene.feat_valid))
    scenes = stack2(scene, blind)
    routes = stack2(packed, packed)
    grid = np.repeat(teach.teach_grid.numpy(), 2, 0)
    store1 = interop.to_numpy_tree(teach.store)
    stores = jax.tree_util.tree_map(lambda x: np.repeat(x, 2, 0), store1)

    jstep = jax.jit(jax.vmap(
        lambda c, t, sc, rt, g, st: j_repeat_step(c, t, sc, rt, g, st, j_cfg),
        in_axes=(0, None, 0, 0, 0, 0)))
    c1 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, x.dtype),
                                init_repeat_carry(packed, wps, n_wps, j_cfg))
    c = jax.tree_util.tree_map(lambda x: jnp.stack([x, x]), c1)
    jtraces, jvio = [], {}
    for t in range(REPEAT_TICKS):
        c, tr_t = jstep(c, jnp.int32(t), scenes, routes, grid, stores)
        jtraces.append(tr_t)
        if t % 10 == 2 or t == REPEAT_TICKS - 1:
            jvio[t] = c.vio            # the state a local-BA tick starts from
    jtrace = jax.tree_util.tree_map(lambda *x: np.stack(x, 1), *jtraces)

    args = (interop.from_numpy_tree(scenes, "cpu"),
            interop.from_numpy_tree(routes, "cpu"),
            torch.from_numpy(grid),
            torch.from_numpy(np.stack([wps, wps])),
            torch.tensor([n_wps, n_wps], dtype=torch.int32))
    tstores = interop.from_numpy_tree(stores, "cpu")
    t_ba = t_run_repeat(*args, t_cfg, REPEAT_TICKS, store=tstores)
    t_rgbd = t_run_repeat(*args, t_rgbd_cfg, FIRST_BA, store=tstores)
    return jtrace, jvio, t_ba, t_rgbd


def _assert_traces_match(ttrace, jtrace, n):
    for f in DISCRETE:
        got = getattr(ttrace, f)[:, :n].numpy()
        want = np.asarray(getattr(jtrace, f))[:, :n]
        bad = np.flatnonzero((got != want).any(0))
        assert len(bad) == 0, f"{f} differs from tick {bad[:1]}"
    for f in ("gt_xy", "gt_yaw", "nav_xy", "vio_xy", "anchor_shift"):
        np.testing.assert_allclose(getattr(ttrace, f)[:, :n].numpy(),
                                   np.asarray(getattr(jtrace, f))[:, :n],
                                   atol=POSE_ATOL, err_msg=f)


def test_rgbd_ba_repeat_matches_jax(runs):
    jtrace, jvio, t_ba, _ = runs
    _assert_traces_match(t_ba.trace, jtrace, REPEAT_TICKS)
    # the state that local BA refines, after its six accepted solves
    want, got = jvio[REPEAT_TICKS - 1], t_ba.final.vio
    for f in ("kf_valid", "kf_ptr", "map_valid", "kf_obs_slot"):
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f))), f
    for f in ("kf_pos", "kf_quat", "map_xyz"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   atol=BA_STATE_ATOL, err_msg=f)


def test_rgbd_repeat_matches_jax_before_the_first_accepted_ba(runs):
    jtrace, jvio, t_ba, t_rgbd = runs
    # the `enough` gate asks for three keyframes: the JAX ring holds fewer
    # at every local-BA tick before FIRST_BA, so the JAX rgbd_ba trace up
    # to there is the JAX rgbd trace
    n_kf = {t + 1: int(np.asarray(v.kf_valid)[0].sum())
            for t, v in jvio.items() if t % 10 == 2}
    assert all(n < 3 for t, n in n_kf.items() if t < FIRST_BA), n_kf
    assert n_kf[FIRST_BA] >= 3
    _assert_traces_match(t_rgbd.trace, jtrace, FIRST_BA)
    # the port's own two modes are the same program up to there, and the
    # BA moves the estimate afterwards
    for a, b in zip(t_rgbd.trace, t_ba.trace):
        assert torch.equal(a, b[:, :FIRST_BA])


def test_local_ba_was_accepted_in_the_window(runs):
    """Route 0 fills its ring and six solves pass the `enough` gate (three
    keyframes, twelve observations, tracking not lost); the blind route
    never has a keyframe."""
    _, jvio, t_ba, _ = runs
    assert int(t_ba.final.vio.kf_valid[0].sum()) >= 6
    assert int(t_ba.final.vio.kf_valid[1].sum()) == 0
    assert not bool(t_ba.trace.vio_flags[0, FIRST_BA:].bitwise_and(8).any())
    assert len([t for t in range(FIRST_BA, REPEAT_TICKS) if t % 10 == 3]) >= 5


def test_jax_vio_state_round_trips(runs):
    """A JAX VioState taken mid-run, its ring filled, converts into the
    port and back unchanged."""
    _, jvio, *_ = runs
    state = jvio[REPEAT_TICKS - 1]
    port = interop.from_numpy_tree(jax.tree_util.tree_map(np.asarray, state),
                                   "cpu")
    assert int(port.kf_valid[0].sum()) >= 6
    back = interop.to_numpy_tree(port)
    for f in state._fields:
        assert np.array_equal(getattr(back, f), np.asarray(getattr(state, f))), f


def test_local_ba_on_a_jax_state_matches_jax(runs):
    """``local_ba`` of both packages on the JAX ``VioState`` that tick 93's
    solve starts from (after 92 repeat ticks, the ring filled): keyframes
    within 1e-4 m and 2e-5 in the quaternion (the two solvers' own
    tolerance), map points within 1e-3 m, the same routes accepted and the
    same map rows written."""
    _, jvio, *_ = runs
    _, _, j_cfg, t_cfg, _ = slice_configs()
    state = jvio[92]
    assert int(np.asarray(state.kf_valid)[0].sum()) >= 6
    jnew = jax.vmap(lambda v: jtracker.local_ba(v, j_cfg.camera,
                                                j_cfg.vio))(state)
    old = jax.tree_util.tree_map(np.asarray, state)
    tnew = ttracker.local_ba(interop.from_numpy_tree(old, "cpu"),
                             t_cfg.camera, t_cfg.vio)
    np.testing.assert_allclose(tnew.kf_pos.numpy(), jnew.kf_pos, atol=1e-4)
    np.testing.assert_allclose(tnew.kf_quat.numpy(), jnew.kf_quat, atol=2e-5)
    np.testing.assert_allclose(tnew.map_xyz.numpy(), jnew.map_xyz, atol=1e-3)
    moved_j = (np.asarray(jnew.kf_pos) != old.kf_pos).any((1, 2))
    moved_t = (tnew.kf_pos.numpy() != old.kf_pos).any((1, 2))
    assert moved_t.tolist() == moved_j.tolist() == [True, False]
    rows_j = (np.asarray(jnew.map_xyz) != old.map_xyz).any(-1)
    rows_t = (tnew.map_xyz.numpy() != old.map_xyz).any(-1)
    assert np.array_equal(rows_t, rows_j) and rows_t[0].sum() >= 20


def test_watchdog_fires_at_the_same_tick(runs):
    jtrace, _, t_ba, _ = runs
    done_t = t_ba.trace.done.numpy()
    assert np.array_equal(done_t, np.asarray(jtrace.done))
    # the parked route is stopped when the warm-up ends; the driving one
    # runs until it reaches its last waypoint
    assert not done_t[1, STALL_WARMUP - 1] and done_t[1, STALL_WARMUP:].all()
    assert not done_t[0, :STALL_WARMUP + STALL_WINDOW // 2].any()
    assert int(t_ba.trace.wp_idx[0, -1]) == 3 and int(t_ba.trace.wp_idx[1, -1]) < 3
    gt = t_ba.trace.gt_xy.numpy()
    assert np.hypot(*(gt[1, -1] - gt[1, 0])) < 0.05
    assert np.hypot(*(gt[0, -1] - gt[0, 0])) > 1.0
