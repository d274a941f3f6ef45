"""Module parity: each ported module against its JAX counterpart on the same
inputs (made with numpy from a seed) and the same PRNG keys.  The JAX side
is vmapped over a small route batch; the port takes the batch as its
leading dimension.

Tolerances: XLA on the CPU contracts ``a * b + c`` into fused multiply-adds
and evaluates sin/cos/exp/log1p with its own approximations, so float
results agree to float32 rounding (~1e-6 relative), not bit for bit;
integer, boolean and descriptor results, and every decision taken on them,
must be equal.
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
from test_rollout_e2e import tiny_scene  # noqa: E402

from nclt_slam_tpu import config as jcfg  # noqa: E402
from nclt_slam_tpu.control import pure_pursuit as jpp  # noqa: E402
from nclt_slam_tpu.dynamics import diffdrive as jdd  # noqa: E402
from nclt_slam_tpu.landmarks import store as jstore  # noqa: E402
from nclt_slam_tpu.mapping import occupancy as jocc  # noqa: E402
from nclt_slam_tpu.planning import dispatcher as jdisp  # noqa: E402
from nclt_slam_tpu.rollout import scene_pack as jpack  # noqa: E402
from nclt_slam_tpu.scene import terrain as jter  # noqa: E402
from nclt_slam_tpu.scene.colliders import default_scene as j_default_scene  # noqa: E402
from nclt_slam_tpu.scene.obstacles import build_drops as j_build_drops  # noqa: E402
from nclt_slam_tpu.scene.routes import get_route as j_get_route  # noqa: E402
from nclt_slam_tpu.sensors import depth as jdepth  # noqa: E402
from nclt_slam_tpu.sensors import features as jfeat  # noqa: E402
from nclt_slam_tpu.rollout.teach import _scene_features as j_scene_features  # noqa: E402
from nclt_slam_tpu_torch import config as tcfg  # noqa: E402
from nclt_slam_tpu_torch import interop  # noqa: E402
from nclt_slam_tpu_torch.control import pure_pursuit as tpp  # noqa: E402
from nclt_slam_tpu_torch.dynamics import diffdrive as tdd  # noqa: E402
from nclt_slam_tpu_torch.landmarks import store as tstore  # noqa: E402
from nclt_slam_tpu_torch.mapping import occupancy as tocc  # noqa: E402
from nclt_slam_tpu_torch.planning import dispatcher as tdisp  # noqa: E402
from nclt_slam_tpu_torch.rollout import scene_pack as tpack  # noqa: E402
from nclt_slam_tpu_torch.rollout.teach import _scene_features as t_scene_features  # noqa: E402
from nclt_slam_tpu_torch.scene import terrain as tter  # noqa: E402
from nclt_slam_tpu_torch.scene.colliders import default_scene as t_default_scene  # noqa: E402
from nclt_slam_tpu_torch.scene.obstacles import build_drops as t_build_drops  # noqa: E402
from nclt_slam_tpu_torch.scene.routes import get_route as t_get_route  # noqa: E402
from nclt_slam_tpu_torch.sensors import depth as tdepth  # noqa: E402
from nclt_slam_tpu_torch.sensors import features as tfeat  # noqa: E402

# the test workers share the CPU: one intra-op thread each keeps their
# torch thread pools from oversubscribing it
torch.set_num_threads(1)

JC = jcfg.DEFAULT
TC = tcfg.DEFAULT
B = 2


def T(x):
    """numpy/JAX -> torch (uint32 -> int64, as the port holds it)."""
    return interop.from_numpy_tree(np.asarray(x))


def N(x):
    return x.detach().numpy()


def batched_scene():
    """The miniature scene of the JAX end-to-end test, as a 2-route batch."""
    s = tiny_scene(drop_on_path=True)
    jb = jax.tree_util.tree_map(lambda x: jnp.stack([x] * B), s)
    return jb, interop.from_numpy_tree(jb)


def keys(seed):
    k = jax.random.split(jax.random.PRNGKey(seed), B)
    return k, T(k)


def test_terrain_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.uniform(-110, 85, 4000).astype(np.float32)
    y = rng.uniform(-55, 50, 4000).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, 4000).astype(np.float32)
    np.testing.assert_allclose(N(tter.terrain_height(T(x), T(y))),
                               np.asarray(jter.terrain_height(x, y)),
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(N(tter.road_y(T(x))),
                               np.asarray(jter.road_y(x)), rtol=0, atol=1e-6)
    # slopes divide height differences by 0.2-0.6 m: rounding grows ~5x
    np.testing.assert_allclose(N(tter.terrain_normal(T(x), T(y))),
                               np.asarray(jter.terrain_normal(x, y)),
                               rtol=0, atol=2e-5)
    for j, t in zip(jter.terrain_pitch_roll(x, y, yaw),
                    tter.terrain_pitch_roll(T(x), T(y), T(yaw))):
        np.testing.assert_allclose(N(t), np.asarray(j), rtol=0, atol=2e-5)


def test_nav_substeps_from_shared_key():
    jsc, tsc = batched_scene()
    rng = np.random.RandomState(1)
    xy = np.stack([rng.uniform(0, 40, B), rng.uniform(-1, 1, B)],
                  -1).astype(np.float32)
    # route 1 starts against the drop barrel at (20, 0.3): it wedges
    xy[1] = (19.0, 0.3)
    yaw = np.array([0.3, 0.0], np.float32)
    v0 = np.array([0.5, 0.7], np.float32)
    cmd_v = np.array([0.8, 0.8], np.float32)
    cmd_w = np.array([-0.4, 0.1], np.float32)
    jk, tk = keys(2)
    jst = jax.vmap(lambda a, b, c: jdd.RobotState(
        a, b, c, jnp.float32(0.1), jnp.array(False)))(xy, yaw, v0)
    valid = jsc.valid & ~jsc.drop_mask.at[1].set(False)
    state = jst
    tstate = interop.from_numpy_tree(jst)
    step = jax.jit(jax.vmap(
        lambda s, v, w, oxy, orad, oval, k: jdd.nav_substeps(
            s, v, w, oxy, orad, oval, k, JC.sim)))
    for tick in range(5):
        kt = jax.vmap(lambda k: jax.random.fold_in(k, tick))(jk)
        state, (jpos, jquat) = step(state, cmd_v, cmd_w, jsc.xy, jsc.radius,
                                    valid, kt)
        tstate, (tpos, tquat) = tdd.nav_substeps(
            tstate, T(cmd_v), T(cmd_w), tsc.xy, tsc.radius, T(valid), T(kt),
            TC.sim)
        np.testing.assert_allclose(N(tstate.xy), np.asarray(state.xy),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(N(tstate.yaw), np.asarray(state.yaw),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(N(tstate.v), np.asarray(state.v),
                                   rtol=0, atol=1e-5)
        assert np.array_equal(N(tstate.wedged), np.asarray(state.wedged))
        np.testing.assert_allclose(N(tpos), np.asarray(jpos), atol=2e-5)
        np.testing.assert_allclose(N(tquat), np.asarray(jquat), atol=2e-5)
    assert bool(np.asarray(state.wedged)[1])


def _cam():
    c = dataclasses.replace(JC.camera, ray_cols=20, ray_rows=15)
    return c, dataclasses.replace(TC.camera, ray_cols=20, ray_rows=15)


def test_render_depth_matches_jax():
    jsc, tsc = batched_scene()
    jc, tc = _cam()
    pos = np.array([[8.0, -0.5, 0.3], [15.0, 0.4, 0.2]], np.float32)
    pos[:, 2] = np.asarray(jter.terrain_height(pos[:, 0], pos[:, 1])) + 0.13
    yaw = np.array([0.2, 2.6], np.float32)
    jd, jp, jv = jax.vmap(lambda p, y, a, b, c, d, e: jdepth.render_depth(
        p, y, a, b, c, d, e, jc))(pos, yaw, jsc.xy, jsc.radius, jsc.base_z,
                                  jsc.height, jsc.valid)
    td, tp, tv = tdepth.render_depth(T(pos), T(yaw), tsc.xy, tsc.radius,
                                     tsc.base_z, tsc.height, tsc.valid, tc)
    jv, tv = np.asarray(jv), N(tv)
    assert jv.mean() > 0.5
    # a terrain-march sample sitting on the surface can flip which
    # coarse/fine step first dips below it: allow 1 % of rays to differ
    agree = (jv == tv)
    assert agree.mean() > 0.99
    both = jv & tv
    close = np.abs(N(td) - np.asarray(jd)) < 1e-4
    assert close[both].mean() > 0.99
    p_cam = tdepth.depth_to_cam_points(td, tc)
    jpc = jax.vmap(lambda d: jdepth.depth_to_cam_points(d, jc))(jd)
    jw = jax.vmap(lambda p, q, y: jdepth.cam_points_to_world(p, q, y, jc))(
        jpc, pos, yaw)
    tw = tdepth.cam_points_to_world(p_cam, T(pos), T(yaw), tc)
    ok = both & close
    np.testing.assert_allclose(N(tw)[ok], np.asarray(jw)[ok], atol=2e-4)


def _depth_points(rng, cam_xy, n):
    ang = rng.uniform(-0.6, 0.6, (B, n))
    rng_m = rng.uniform(0.5, 10.0, (B, n))
    pts = np.stack([cam_xy[:, None, 0] + rng_m * np.cos(ang),
                    cam_xy[:, None, 1] + rng_m * np.sin(ang),
                    rng.uniform(-0.2, 2.5, (B, n))], -1).astype(np.float32)
    valid = rng.rand(B, n) > 0.1
    return pts, valid


def test_integrate_depth_trinary_inflate_match_jax():
    rng = np.random.RandomState(3)
    mc = dataclasses.replace(JC.map, resolution=0.2, width_m=120.0,
                             height_m=40.0, origin_x=-20.0, origin_y=-20.0)
    tmc = dataclasses.replace(TC.map, **dataclasses.asdict(mc))
    grid = rng.uniform(-2, 2, (B, mc.rows, mc.cols)).astype(np.float32)
    cam_xy = np.array([[5.0, 1.0], [30.0, -2.0]], np.float32)
    jg, tg = jnp.asarray(grid), T(grid)
    integ = jax.jit(jax.vmap(lambda g, c, p, v: jocc.integrate_depth(
        g, c, p, v, mc)))
    for _ in range(3):
        pts, valid = _depth_points(rng, cam_xy, 600)
        jg = integ(jg, cam_xy, pts, valid)
        tg = tocc.integrate_depth(tg, T(cam_xy), T(pts), T(valid), tmc)
    # scatter-add order differs from XLA's: sums agree to rounding
    np.testing.assert_allclose(N(tg), np.asarray(jg), rtol=0, atol=1e-5)
    jt = jax.vmap(lambda g: jocc.occupancy_trinary(g, mc))(jg)
    tt = tocc.occupancy_trinary(tg, tmc)
    assert (N(tt) == np.asarray(jt)).mean() > 0.9999
    r, c = jax.vmap(lambda xy: jocc.world_to_cell(xy[0], xy[1], mc))(cam_xy)
    tr, tcc = tocc.world_to_cell(T(cam_xy)[:, 0], T(cam_xy)[:, 1], tmc)
    assert np.array_equal(N(tr), np.asarray(r))
    jw, jr0, jc0 = jax.vmap(lambda g, a, b: jocc.crop_window(g, a, b, 64))(
        jt, r, c)
    tw, tr0, tc0 = tocc.crop_window(T(jt), tr, tcc, 64)
    assert np.array_equal(N(tw), np.asarray(jw))
    assert np.array_equal(N(tr0), np.asarray(jr0))
    jcost = jax.vmap(lambda w: jocc.inflate_cost(w, mc))(jw)
    tcost = tocc.inflate_cost(tw, tmc)
    # exp() differs by an ulp between XLA and torch
    np.testing.assert_allclose(N(tcost), np.asarray(jcost), rtol=2e-6,
                               atol=1e-5)
    assert np.array_equal(N(tcost) >= 99.0, np.asarray(jcost) >= 99.0)


def _observe_inputs(seed):
    jsc, tsc = batched_scene()
    pos = np.array([[6.0, 0.2, 0.3], [24.0, -0.3, 0.3]], np.float32)
    pos[:, 2] = np.asarray(jter.terrain_height(pos[:, 0], pos[:, 1])) + 0.13
    yaw = np.array([0.1, np.pi - 0.2], np.float32)
    yaw_rate = np.array([0.3, 0.0], np.float32)
    jk, tk = keys(seed)
    return jsc, tsc, pos, yaw, yaw_rate, jk, tk


@pytest.mark.parametrize("with_occluders", [False, True])
def test_observe_matches_jax(with_occluders):
    jsc, tsc, pos, yaw, yaw_rate, jk, tk = _observe_inputs(4)
    valid_now = np.asarray(jsc.valid)
    occ_j = occ_t = None
    if with_occluders:
        act = np.asarray(jsc.valid & jsc.drop_mask)
        idx = np.arange(jsc.xy.shape[1], dtype=np.int32)
        occ_j = (jsc.xy, jsc.radius, jsc.base_z, jsc.height, act,
                 np.stack([idx] * B))
        occ_t = (tsc.xy, tsc.radius, tsc.base_z, tsc.height, T(act), T(idx))
    jo = jax.vmap(lambda p, y, sc, v, k, w, oc: jfeat.observe(
        p, y, j_scene_features(sc), v, k, JC.camera, JC.landmarks,
        yaw_rate=w, occluders=oc,
        px_session_amp=0.8 if with_occluders else 0.0))(
        pos, yaw, jsc, valid_now, jk, yaw_rate, occ_j)
    to = tfeat.observe(T(pos), T(yaw), t_scene_features(tsc), T(valid_now),
                       tk, TC.camera, TC.landmarks, yaw_rate=T(yaw_rate),
                       occluders=occ_t,
                       px_session_amp=0.8 if with_occluders else 0.0)
    valid = np.asarray(jo.valid)
    assert valid.sum() > 50
    assert np.array_equal(N(to.feat_id), np.asarray(jo.feat_id))
    assert np.array_equal(N(to.valid), valid)
    assert np.array_equal(interop.to_numpy_tree(to.desc), np.asarray(jo.desc))
    # projection: division by the depth amplifies rounding (~1e-5 px)
    np.testing.assert_allclose(N(to.uv)[valid], np.asarray(jo.uv)[valid],
                               rtol=0, atol=2e-3)
    np.testing.assert_allclose(N(to.p3d_cam)[valid],
                               np.asarray(jo.p3d_cam)[valid], rtol=1e-5,
                               atol=1e-5)


def test_record_tick_matches_jax():
    jsc, tsc, pos, yaw, yaw_rate, jk, tk = _observe_inputs(6)
    lc = JC.landmarks
    jst = jax.vmap(lambda _: jstore.init_store(lc))(jnp.arange(B))
    tst = tstore.init_store(TC.landmarks, B)
    valid_now = np.asarray(jsc.valid)
    obs = jax.jit(jax.vmap(lambda a, y, sc, v, k: jfeat.observe(
        a, y, j_scene_features(sc), v, k, JC.camera, lc)))
    rec = jax.jit(jax.vmap(lambda s, o, a, y: jstore.record_tick(
        s, o, jdepth.camera_pose(a, y, JC.camera)[0], y, JC.camera, lc)))
    for step in range(3):
        p = pos.copy()
        p[:, 0] += 2.5 * step * np.array([1, -1])
        jkk = jax.vmap(lambda k: jax.random.fold_in(k, step))(jk)
        jo = obs(p, yaw, jsc, valid_now, jkk)
        cam_p, _ = jax.vmap(lambda a, y: jdepth.camera_pose(a, y, JC.camera))(
            p, yaw)
        jst = rec(jst, jo, p, yaw)
        tst = tstore.record_tick(tst, interop.from_numpy_tree(jo), T(cam_p),
                                 T(yaw), TC.camera, TC.landmarks)
    assert int(np.asarray(jst.count).min()) >= 2
    for f in ("desc", "feat_valid", "n_feats", "count", "has_last"):
        assert np.array_equal(interop.to_numpy_tree(getattr(tst, f)),
                              np.asarray(getattr(jst, f))), f
    for f in ("cam_pos", "cam_yaw", "p3d_cam", "uv", "last_pos"):
        np.testing.assert_array_equal(N(getattr(tst, f)),
                                      np.asarray(getattr(jst, f)), err_msg=f)


def test_pack_scene_and_route_match_jax():
    scene = j_default_scene(7)
    assert np.array_equal(t_default_scene(7).xy, scene.xy)
    jr, tr = j_get_route("07_se_sw"), t_get_route("07_se_sw")
    assert np.array_equal(jr.dense_xy, tr.dense_xy)
    jd, td = j_build_drops(jr), t_build_drops(tr)
    for a, b in zip(jd, td):
        assert np.array_equal(a, b)
    jp = jpack.pack_scene(scene, jd, cfg=JC, session=1)
    tp = tpack.pack_scene(t_default_scene(7), td, cfg=TC, session=1)
    for f in ("xy", "radius", "height", "valid", "drop_mask", "feat_owner",
              "feat_valid", "feat_view_thr", "feat_view_alpha", "feat_pkeep"):
        assert np.array_equal(interop.to_numpy_tree(getattr(tp, f)),
                              np.asarray(getattr(jp, f))), f
    assert np.array_equal(interop.to_numpy_tree(tp.feat_desc),
                          np.asarray(jp.feat_desc))
    # base_z and the ground features' z come from terrain_height (XLA's
    # sin/cos vs torch's)
    np.testing.assert_allclose(N(tp.base_z), np.asarray(jp.base_z), atol=2e-6)
    np.testing.assert_allclose(N(tp.feat_xyz), np.asarray(jp.feat_xyz),
                               rtol=0, atol=4e-6)
    jpr, tpr = jpack.pack_route(jr, JC), tpack.pack_route(tr, TC)
    for a, b in zip(jpr, tpr):
        assert np.array_equal(np.asarray(a), N(b))


def _dispatch_inputs(rng):
    pc = dataclasses.replace(JC.planner, window=64, path_len=96,
                             max_waypoints=32, goal_timeout_ticks=200)
    tpc = dataclasses.replace(TC.planner, **dataclasses.asdict(pc))
    W = 64
    cost = rng.uniform(0, 20, (B, W, W)).astype(np.float32)
    cost[:, 20:24, 5:60] = 99.0
    cost[rng.rand(B, W, W) < 0.02] = 80.0
    r0 = np.array([400, 420], np.int32)
    c0 = np.array([900, 950], np.int32)
    mc = JC.map
    # window corner + 3.7 cm: keep points off cell boundaries, where an
    # FMA-rounded coordinate could fall into the neighbouring cell
    origin = np.stack([mc.origin_x + c0 * 0.1, mc.origin_y + r0 * 0.1],
                      -1).astype(np.float32) + np.float32(0.037)
    wps = origin[:, None, :] + np.stack(
        [np.linspace(1, 12, 32), np.linspace(0.5, 5.5, 32)], -1)[None]
    wps = wps.astype(np.float32)
    n_wps = np.array([20, 32], np.int32)
    known_xy = np.stack([wps[:, 5] + 0.3, wps[:, 9]], 1).astype(np.float32)
    known_r = np.full((B, 2), 0.5, np.float32)
    known_act = np.array([[True, False], [True, True]])
    return pc, tpc, cost, r0, c0, origin, wps, n_wps, known_xy, known_r, \
        known_act


def test_dispatch_plan_and_move_match_jax():
    rng = np.random.RandomState(8)
    pc, tpc, cost, r0, c0, origin, wps, n_wps, kxy, kr, ka = \
        _dispatch_inputs(rng)
    mc = JC.map
    js = jax.vmap(lambda w, n: jdisp.init_dispatch(w, n, pc))(wps, n_wps)
    ts = tdisp.init_dispatch(T(wps), T(n_wps), tpc)
    robot = origin + np.array([0.52, 0.31], np.float32)
    plan = jax.jit(jax.vmap(
        lambda s, x, c, a, b, k1, k2, k3, t: jdisp.dispatch_plan(
            s, x, c, a, b, k1, k2, k3, mc, pc, t),
        in_axes=(0,) * 8 + (None,)))
    move = jax.jit(jax.vmap(lambda s, x, k1, k2, k3: jdisp.dispatch_move(
        s, x, k1, k2, k3, pc)))
    for tick in range(0, 60, 5):
        js = plan(js, robot, cost, r0, c0, kxy, kr, ka, jnp.int32(tick))
        ts = tdisp.dispatch_plan(ts, T(robot), T(cost), T(r0), T(c0), T(kxy),
                                 T(kr), T(ka), TC.map, tpc, tick)
        for _ in range(5):
            js = move(js, robot, kxy, kr, ka)
            ts = tdisp.dispatch_move(ts, T(robot), T(kxy), T(kr), T(ka), tpc)
        # drive the robot halfway to its target
        robot = (robot + 0.5 * (np.asarray(js.target) - robot)).astype(
            np.float32)
        for f in ("idx", "skip", "plan_fails", "n_path", "has_path",
                  "plan_version", "plan_tick", "reached_count",
                  "skipped_count", "done", "goal_blocked", "ticks_on_wp"):
            assert np.array_equal(N(getattr(ts, f)),
                                  np.asarray(getattr(js, f))), (tick, f)
        for f in ("wps_proj", "target", "path_xy", "planned_target"):
            np.testing.assert_allclose(N(getattr(ts, f)),
                                       np.asarray(getattr(js, f)),
                                       rtol=0, atol=1e-4, err_msg=f)
    assert int(np.asarray(js.reached_count).sum()) > 3


def test_follower_tick_matches_jax():
    rng = np.random.RandomState(9)
    W = 64
    mc = JC.map
    cost = rng.uniform(0, 60, (B, W, W)).astype(np.float32)
    cost[rng.rand(B, W, W) < 0.05] = 99.0
    r0 = np.array([400, 420], np.int32)
    c0 = np.array([900, 950], np.int32)
    origin = np.stack([mc.origin_x + c0 * 0.1, mc.origin_y + r0 * 0.1],
                      -1).astype(np.float32)
    path = (origin[:, None, :] + np.stack(
        [np.linspace(0.5, 5.5, 96), 0.3 * np.sin(np.linspace(0, 6, 96))],
        -1)[None]).astype(np.float32)
    n_path = np.array([60, 96], np.int32)
    js = jax.vmap(lambda _: jpp.init_ctrl())(jnp.arange(B))
    ts = tpp.init_ctrl(B)
    pos = origin + np.array([0.4, 0.1], np.float32)
    yaw = np.array([0.2, -0.4], np.float32)
    active = np.array([True, True])
    follow = jax.jit(jax.vmap(
        lambda s, p, y, px, n, a, v, c, a0, b0, t: jpp.follower_tick(
            s, p, y, px, n, a, v, c, a0, b0, t, mc, JC.control, W),
        in_axes=(0,) * 10 + (None,)))
    for tick in range(80):
        t_now = np.float32(tick) * np.float32(0.1)
        ver = np.full(B, tick // 30, np.int32)
        js, jv, jw = follow(js, pos, yaw, path, n_path, active, ver, cost, r0,
                            c0, t_now)
        ts, tv, tw = tpp.follower_tick(ts, T(pos), T(yaw), T(path), T(n_path),
                                       T(active), T(ver), T(cost), T(r0),
                                       T(c0), torch.tensor(t_now), TC.map,
                                       TC.control, W)
        np.testing.assert_allclose(N(tv), np.asarray(jv), atol=1e-5)
        np.testing.assert_allclose(N(tw), np.asarray(jw), atol=1e-5)
        for f in ("hist_n", "path_idx", "prox_activations",
                  "spin_activations", "wedge_activations"):
            assert np.array_equal(N(getattr(ts, f)),
                                  np.asarray(getattr(js, f))), (tick, f)
        # route 0 drives; route 1 is stuck (wedge recovery must trigger)
        step = np.stack([np.cos(yaw), np.sin(yaw)], -1) * \
            np.asarray(jv)[:, None] * 0.1
        step[1] = 0.0
        pos = (pos + step).astype(np.float32)
        yaw = (yaw + np.asarray(jw) * 0.1).astype(np.float32)
    assert int(np.asarray(js.wedge_activations)[1]) >= 1
