"""The whole ours slice — a VIO teach, waypoints from the aligned VIO
track, then the full-stack repeat (``config.ours()``: VIO + anchors + v55
fusion) — against the JAX package from the same seed, on the miniature
scene/route/config of ``tests/test_rollout_e2e.py``.

The teach half is held to JAX in ``tests/test_torch_vio.py``; here the
port's VIO teach makes the artefacts (map, landmark store, VIO track), and
both packages' waypoint extraction and repeat consume the same ones.  The
repeat's landmark session keeps every view alive
(``session_dead_frac=0``) so that anchors publish inside the short window.

Tolerance: every discrete sequence — fusion regime, anchor published /
reason / inliers, VIO match counts and flags, waypoint index, done — is
equal, and the poses agree to 1e-3 m, up to tick ``FLIP_TICK``.  The
float32 rounding of the Gauss-Newton, Kabsch and relay products moves the
two robots apart by ~1e-6 m a tick, through the follower's commands, to
1e-4 m / 2e-5 rad by tick 114; at tick 115 one scene feature (id 873)
projects to u = 638.09 px, at the image-border gate ``u < width - 1`` of
``observe``, and is visible to the JAX package only.  The observations,
then the VIO match counts and the anchor's inliers, differ from there.
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
from test_rollout_e2e import (  # noqa: E402
    pack_test_route,
    small_config,
    straight_route,
    tiny_scene,
)

from nclt_slam_tpu import config as jcfg_mod  # noqa: E402
from nclt_slam_tpu.rollout import campaign as jcamp  # noqa: E402
from nclt_slam_tpu.rollout.repeat import (  # noqa: E402
    RepeatResult,
    init_repeat_carry,
)
from nclt_slam_tpu.rollout.repeat import repeat_step as j_repeat_step  # noqa: E402
from nclt_slam_tpu_torch import config as tcfg_mod  # noqa: E402
from nclt_slam_tpu_torch import interop  # noqa: E402
from nclt_slam_tpu_torch.rollout import campaign as tcamp  # noqa: E402
from nclt_slam_tpu_torch.rollout.repeat import run_repeat as t_run_repeat  # noqa: E402
from nclt_slam_tpu_torch.rollout.teach import run_teach as t_run_teach  # noqa: E402

# the test workers share the CPU: one intra-op thread each keeps their
# torch thread pools from oversubscribing it
torch.set_num_threads(1)

TEACH_TICKS = 100
REPEAT_TICKS = 120
FLIP_TICK = 115   # first tick at which a visibility gate flips (see above)
POSE_ATOL = 1e-3
DISCRETE = ("regime", "anchor_ok", "anchor_reason", "anchor_inliers",
            "vio_tracked", "vio_ndesc", "vio_nins", "vio_flags", "wp_idx",
            "done", "fired")


def configs():
    base = small_config()
    jt = base.replace(teach=dataclasses.replace(base.teach, run_vio=True))
    jr = jcfg_mod.ours().replace(
        camera=jt.camera, map=jt.map, planner=jt.planner,
        landmarks=dataclasses.replace(jt.landmarks, session_dead_frac=0.0))

    def port(j, t):
        return t.replace(**{name: dataclasses.replace(
            getattr(t, name), **dataclasses.asdict(getattr(j, name)))
            for name in ("camera", "map", "planner", "teach", "landmarks")})

    tt = port(jt, tcfg_mod.gt_localization())
    tr = port(jr, tcfg_mod.ours())
    assert dataclasses.asdict(tt) == dataclasses.asdict(jt)
    assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
    return jt, tt, jr, tr


def batch1(tree):
    return interop.from_numpy_tree(jax.tree_util.tree_map(
        lambda x: np.asarray(x)[None], tree), "cpu")


def unbatch(tree):
    """The port's 1-route batch -> a JAX tree of one route."""
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x[0]),
                                  interop.to_numpy_tree(tree))


@pytest.fixture(scope="module")
def runs():
    jt_cfg, tt_cfg, jr_cfg, tr_cfg = configs()
    packed, _, _ = pack_test_route(straight_route(), jt_cfg)
    teach = t_run_teach(batch1(tiny_scene(drop_on_path=False)),
                        batch1(packed), tt_cfg, TEACH_TICKS)
    # waypoints from the aligned VIO track, both packages on the same trace
    trace_np = interop.to_numpy_tree(teach.trace)
    jdata = jcamp.CampaignData(None, None, jax.tree_util.tree_map(
        lambda x: np.asarray(x)[None], packed), ("straight",))
    tdata = tcamp.CampaignData(None, None, batch1(packed), ("straight",))
    jw, jn = jcamp.teach_waypoints(
        jdata, teach._replace(trace=trace_np), jr_cfg, source="vio")
    tw, tn = tcamp.teach_waypoints(
        tdata, teach._replace(trace=trace_np), tr_cfg, source="vio")
    grid = teach.teach_grid[0].numpy()
    store = unbatch(teach.store)
    wps, n_wps = np.asarray(jw)[0], int(np.asarray(jn)[0])
    scene = tiny_scene(drop_on_path=True)

    # JAX's repeat as run_repeat's scan body, one jitted tick at a time, so
    # that the carry test below steps the same compiled tick
    def jstep(c, t):
        return _jstep(c, jnp.int32(t), scene, packed, grid, store)

    _jstep = jax.jit(lambda c, t, sc, rt, g, st: j_repeat_step(
        c, t, sc, rt, g, st, jr_cfg))
    # weakly typed scalars of the initial carry made strict, as lax.scan
    # makes them, so that the tick compiles once
    c = jax.tree_util.tree_map(lambda x: jnp.asarray(x, x.dtype),
                               init_repeat_carry(packed, wps, n_wps, jr_cfg))
    jtraces = []
    for t in range(REPEAT_TICKS):
        c, tr_t = jstep(c, t)
        jtraces.append(tr_t)
    jr = RepeatResult(trace=jax.tree_util.tree_map(
        lambda *x: np.stack(x), *jtraces), final=c)
    tr = t_run_repeat(batch1(scene), batch1(packed),
                      torch.from_numpy(grid)[None],
                      torch.from_numpy(wps)[None],
                      torch.tensor([n_wps], dtype=torch.int32), tr_cfg,
                      REPEAT_TICKS, store=teach.store)
    return teach, (jw, jn, tw, tn), jr, tr, jstep


def test_vio_waypoints_match_jax(runs):
    teach, (jw, jn, tw, tn), *_ = runs
    assert np.array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5)
    assert int(tn[0]) >= 2
    # the VIO track, not GT, is the source: they differ by the drift
    assert (teach.trace.vio_xy[0] != teach.trace.gt_xy[0]).any()


def test_ours_repeat_matches_jax(runs):
    _, _, jr, tr, _ = runs
    n = FLIP_TICK
    for f in DISCRETE:
        got = getattr(tr.trace, f)[0, :n].numpy()
        want = np.asarray(getattr(jr.trace, f))[:n]
        bad = np.flatnonzero(got != want)
        assert len(bad) == 0, f"{f} differs from tick {bad[:1]}"
    for f in ("gt_xy", "gt_yaw", "nav_xy", "vio_xy", "anchor_shift"):
        np.testing.assert_allclose(getattr(tr.trace, f)[0, :n].numpy(),
                                   np.asarray(getattr(jr.trace, f))[:n],
                                   atol=POSE_ATOL, err_msg=f)
    # the relay committed the same alignment (it does not move afterwards)
    np.testing.assert_allclose(tr.final.fusion.T_nav_slam[0].numpy(),
                               np.asarray(jr.final.fusion.T_nav_slam),
                               atol=POSE_ATOL)


def test_ours_repeat_exercised_the_stack(runs):
    """The window is long enough to commit the relay, publish anchors,
    leave the startup hold and drive."""
    _, _, jr, *_ = runs
    assert bool(jr.final.fusion.committed)
    assert np.asarray(jr.trace.anchor_ok).sum() >= 2
    assert {1, 2} & set(np.unique(np.asarray(jr.trace.regime)).tolist())
    gt = np.asarray(jr.trace.gt_xy)
    assert np.hypot(*(gt[-1] - gt[0])) > 1.0
    assert (np.asarray(jr.trace.cmd_v)[:20] == 0).all()   # startup hold


def preset_configs():
    """Every preset of the JAX package, and each flag that selects a
    branch of the repeat tick, on the miniature scene of ``configs()``."""
    from nclt_slam_tpu_torch.baselines import configs as tbase

    _, _, _, tr = configs()
    return {
        "ours": tcfg_mod.ours(),
        "gt_localization": tcfg_mod.gt_localization(),
        "encoder_only": tcfg_mod.encoder_only(),
        "rgbd_no_imu": tcfg_mod.rgbd_no_imu(),
        "baselines.rgbd_no_imu": tbase.rgbd_no_imu(),
        "baselines.rgbd_ba": tbase.rgbd_ba(),
        "baselines.stock_nav2": tbase.stock_nav2(),
        "ours.no_anchors": tr.replace(mode=dataclasses.replace(
            tr.mode, use_anchors=False)),
        "ours.use_rpp": tr.replace(control=dataclasses.replace(
            tr.control, use_rpp=True)),
        "ours.stock_follow": tr.replace(planner=dataclasses.replace(
            tr.planner, stock_follow=True)),
        "ours.ray_terrain_tex": tr.replace(camera=dataclasses.replace(
            tr.camera, ray_terrain_tex=True)),
    }


@pytest.mark.parametrize("name", sorted(preset_configs()))
def test_every_preset_steps_a_repeat_tick(runs, name):
    """One repeat tick (a matcher, costmap and plan tick) of each preset on
    the CPU: every localization source, follower and dispatcher branch of
    the port runs, and each writes the trace fields its mode defines."""
    from nclt_slam_tpu_torch.rollout.repeat import init_repeat_carry as t_init
    from nclt_slam_tpu_torch.rollout.repeat import repeat_step

    teach, *_ = runs
    jt_cfg, _, _, tr = configs()
    preset = preset_configs()[name]
    cfg = preset.replace(
        camera=dataclasses.replace(
            tr.camera, ray_terrain_tex=preset.camera.ray_terrain_tex),
        map=tr.map, landmarks=tr.landmarks,
        planner=dataclasses.replace(preset.planner, **{
            k: getattr(tr.planner, k) for k in
            ("window", "path_len", "max_waypoints", "goal_timeout_ticks")}))
    packed, wps, n_wps = pack_test_route(straight_route(), jt_cfg)
    route = batch1(packed)
    carry = t_init(route, torch.from_numpy(np.asarray(wps))[None],
                   torch.tensor([n_wps], dtype=torch.int32), cfg)
    carry, trace = repeat_step(carry, 0, batch1(tiny_scene(drop_on_path=True)),
                               route, teach.teach_grid, teach.store, cfg)
    assert torch.isfinite(trace.nav_xy).all() and \
        torch.isfinite(carry.cmd).all()
    m = cfg.mode
    assert (int(trace.regime[0]) == -1) == m.use_gt
    assert (int(trace.anchor_reason[0]) >= 0) == (m.use_anchors
                                                  and not m.use_gt)
    assert (int(trace.vio_ndesc[0]) >= 0) == (m.use_slam and not m.use_gt)
    assert (int(trace.recovery_phase[0]) >= 0) == cfg.control.use_rpp
    assert type(carry.ctrl).__name__ == \
        ("RppState" if cfg.control.use_rpp else "CtrlState")
    if not m.use_slam:
        assert not trace.vio_xy.any()
    if m.use_gt:
        assert torch.equal(trace.nav_xy, trace.gt_xy)


def test_jax_ours_carry_round_trips_and_steps(runs):
    """A JAX ours-mode repeat carry taken mid-run — a filled VIO map, a
    committed relay — converts into the port and back unchanged, and both
    packages step it one tick (a matcher tick, so the anchor stack runs) to
    the same trace: discrete fields equal, poses within POSE_ATOL."""
    from nclt_slam_tpu_torch.rollout.repeat import repeat_step

    teach, _, jr, _, jstep = runs
    jt_cfg, _, jr_cfg, tr_cfg = configs()
    carry = batch1(jr.final)
    back = interop.to_numpy_tree(carry)
    for got, want in zip(jax.tree_util.tree_leaves(back),
                         jax.tree_util.tree_leaves(jr.final)):
        assert np.array_equal(got[0], np.asarray(want))
    assert bool(carry.fusion.committed[0]) and bool(carry.vio.map_valid.any())
    assert REPEAT_TICKS % jr_cfg.landmarks.tick_period == 0
    packed, _, _ = pack_test_route(straight_route(), jt_cfg)
    _, jtrace = jstep(jr.final, REPEAT_TICKS)
    _, trace = repeat_step(carry, REPEAT_TICKS,
                           batch1(tiny_scene(drop_on_path=True)),
                           batch1(packed), teach.teach_grid, teach.store,
                           tr_cfg)
    for f in DISCRETE:
        assert np.array_equal(getattr(trace, f)[0].numpy(),
                              np.asarray(getattr(jtrace, f))), f
    for f in ("gt_xy", "gt_yaw", "nav_xy", "vio_xy", "anchor_shift"):
        np.testing.assert_allclose(getattr(trace, f)[0].numpy(),
                                   np.asarray(getattr(jtrace, f)),
                                   atol=POSE_ATOL, err_msg=f)
    assert int(trace.vio_tracked[0]) >= 8
    assert int(trace.anchor_reason[0]) >= 0       # the matcher ran
