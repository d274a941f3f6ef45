"""The port's VIO stack against the JAX package on the CPU: the IMU block,
preintegration, one ``vio_frame`` from a JAX carry taken mid-drive, the
duplicate-index scatter order, the drift monitor, and the VIO teach
(``teach.run_vio=True``) on the miniature scene/route of
``tests/test_rollout_e2e.py``.

Tolerances.  The threefry draws are bit-exact and the normals within
4 ulps; float32 arithmetic differs in rounding (XLA fuses multiply-adds and
reduces in its own order), so the IMU and preintegration agree to 1e-6
relative, a VIO pose to 1e-4 m after one frame, and the 120-tick teach
traces to 1e-3 m.  Every discrete outcome (matches, map slots, flags,
tracked counts) must be equal.
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

from nclt_slam_tpu.rollout.teach import run_teach as j_run_teach  # noqa: E402
from nclt_slam_tpu.sensors import imu as jimu  # noqa: E402
from nclt_slam_tpu.vio import drift_monitor as jdm  # noqa: E402
from nclt_slam_tpu.vio import preintegration as jpre  # noqa: E402
from nclt_slam_tpu.vio import tracker as jtr  # noqa: E402
from nclt_slam_tpu_torch import config as tcfg  # noqa: E402
from nclt_slam_tpu_torch import interop  # noqa: E402
from nclt_slam_tpu_torch.rollout.teach import run_teach as t_run_teach  # noqa: E402
from nclt_slam_tpu_torch.sensors import imu as timu  # noqa: E402
from nclt_slam_tpu_torch.vio import drift_monitor as tdm  # noqa: E402
from nclt_slam_tpu_torch.vio import preintegration as tpre  # noqa: E402
from nclt_slam_tpu_torch.vio import tracker as ttr  # noqa: E402

# the test workers share the CPU: one intra-op thread each keeps their
# torch thread pools from oversubscribing it
torch.set_num_threads(1)

TICKS = 120
POSE_ATOL = 1e-3


def vio_teach_configs():
    j = small_config()
    j = j.replace(teach=dataclasses.replace(j.teach, run_vio=True))
    base = tcfg.gt_localization()
    t = base.replace(**{
        name: dataclasses.replace(getattr(base, name),
                                  **dataclasses.asdict(getattr(j, name)))
        for name in ("camera", "map", "planner", "teach")})
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    return j, t


def batched(tree):
    """A JAX tree with a leading route axis -> the port's tensors."""
    return interop.from_numpy_tree(jax.tree_util.tree_map(np.asarray, tree))


def batch1(tree):
    return interop.from_numpy_tree(jax.tree_util.tree_map(
        lambda x: np.asarray(x)[None], tree))


def _t(x):
    x = np.asarray(x)
    return torch.from_numpy(x.astype(np.int64) if x.dtype == np.uint32
                            else x)


@pytest.fixture(scope="module")
def teach_runs():
    """The JAX teach in two halves (one compiled chunk), the port's from the
    same seed, and the port continuing the JAX carry of the first half."""
    from nclt_slam_tpu.rollout.teach import init_teach_carry

    jcfg, tc = vio_teach_configs()
    packed, _, _ = pack_test_route(straight_route(), jcfg)
    scene = tiny_scene(drop_on_path=False)
    half = TICKS // 2
    chunk = jax.jit(lambda c, t0: j_run_teach(scene, packed, jcfg, half,
                                              carry=c, tick0=t0))
    # strongly typed leaves, so that the second call reuses the compile
    c0 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, x.dtype),
                                init_teach_carry(packed, jcfg))
    j1 = chunk(c0, jnp.int32(0))
    j2 = chunk(j1.final, jnp.int32(half))
    jt = j2._replace(trace=jax.tree_util.tree_map(
        lambda a, b: jnp.concatenate([a, b]), j1.trace, j2.trace))
    tt = t_run_teach(batch1(scene), batch1(packed), tc, TICKS)
    tcont = t_run_teach(batch1(scene), batch1(packed), tc, half,
                        carry=batch1(j1.final), tick0=half)
    return jt, tt, j2, tcont


def test_teach_continues_a_carried_jax_carry(teach_runs):
    """A JAX TeachCarry taken mid-run (tick 60: a VIO map, a drift monitor
    with samples, a landmark store) loads into the port, and both packages
    step it the same way."""
    _, _, j2, tcont = teach_runs
    assert int(np.asarray(j2.final.drift.n)) > 0
    for f in ("vio_tracked", "done", "aborted"):
        assert np.array_equal(getattr(tcont.trace, f)[0].numpy(),
                              np.asarray(getattr(j2.trace, f))), f
    for f in ("gt_xy", "vio_xy", "drift_max"):
        np.testing.assert_allclose(getattr(tcont.trace, f)[0].numpy(),
                                   np.asarray(getattr(j2.trace, f)),
                                   atol=POSE_ATOL, err_msg=f)
    jv, tv = j2.final.vio, tcont.final.vio
    for f in ("map_valid", "map_age", "map_obs", "kf_ptr", "frames"):
        assert np.array_equal(getattr(tv, f)[0].numpy(),
                              np.asarray(getattr(jv, f))), f
    assert np.array_equal(tcont.store.count.numpy(),
                          np.asarray(j2.store.count)[None])


def test_vio_teach_matches_jax(teach_runs):
    jt, tt, _, _ = teach_runs
    gt = np.asarray(jt.trace.gt_xy)
    assert np.hypot(*(gt[-1] - gt[0])) > 5.0          # the robot drove
    tracked = np.asarray(jt.trace.vio_tracked)
    assert (tracked[10:] >= 8).all()                  # VIO tracked
    np.testing.assert_allclose(tt.trace.gt_xy[0].numpy(), gt, atol=POSE_ATOL)
    np.testing.assert_allclose(tt.trace.vio_xy[0].numpy(),
                               np.asarray(jt.trace.vio_xy), atol=POSE_ATOL)
    assert np.array_equal(tt.trace.vio_tracked[0].numpy(), tracked)
    assert np.array_equal(tt.trace.done[0].numpy(), np.asarray(jt.trace.done))
    np.testing.assert_allclose(tt.trace.drift_max[0].numpy(),
                               np.asarray(jt.trace.drift_max), atol=POSE_ATOL)
    # the VIO map: the same slots hold the same descriptors
    jv, tv = jt.final.vio, tt.final.vio
    assert np.array_equal(tv.map_valid[0].numpy(), np.asarray(jv.map_valid))
    assert np.array_equal(interop.to_numpy_tree(tv.map_desc[0]),
                          np.asarray(jv.map_desc))
    assert np.array_equal(tv.map_age[0].numpy(), np.asarray(jv.map_age))
    assert np.array_equal(tv.map_obs[0].numpy(), np.asarray(jv.map_obs))
    np.testing.assert_allclose(tv.map_xyz[0].numpy(), np.asarray(jv.map_xyz),
                               atol=POSE_ATOL)
    assert np.array_equal(tv.kf_ptr[0].numpy(), np.asarray(jv.kf_ptr))
    # the landmark recorder reused the VIO observation
    assert np.array_equal(tt.store.count.numpy(),
                          np.asarray(jt.store.count)[None])
    assert np.array_equal(interop.to_numpy_tree(tt.store.desc[0]),
                          np.asarray(jt.store.desc))


def test_vio_frame_from_a_carried_jax_state(teach_runs):
    """Both packages step the JAX teach's VIO state (tick 120, a filled
    map) with the same observation, IMU block and key."""
    jt, _, _, _ = teach_runs
    jcfg, tc = vio_teach_configs()
    jstate = jt.final.vio
    # the next frame's inputs: the map's own points seen from the current
    # pose, through the JAX observation of the teach scene
    from nclt_slam_tpu.rollout.teach import _scene_features
    from nclt_slam_tpu.sensors.features import observe
    robot = jt.final.robot
    scene = tiny_scene(drop_on_path=False)
    from nclt_slam_tpu.dynamics.diffdrive import robot_pose3d
    pos3, _ = robot_pose3d(robot)
    obs = observe(pos3, robot.yaw, _scene_features(scene), scene.valid,
                  jax.random.PRNGKey(5), jcfg.camera, jcfg.landmarks)
    rng = np.random.RandomState(2)
    meas = np.concatenate([rng.normal(0, 0.05, (20, 3)) + [0, 0, 9.81],
                           rng.normal(0, 0.01, (20, 3))], -1)
    meas = meas.astype(np.float32)
    key = jax.random.PRNGKey(9)
    grav = jnp.array([0.0, 0.0, -9.81])
    jnew, jok, jaux = jax.jit(lambda s, o, m, k: jtr.vio_frame(
        s, o, m, 0.1, grav, jcfg.camera, jcfg.vio, True, key=k))(
            jstate, obs, meas, key)
    tnew, tok, taux = ttr.vio_frame(
        batch1(jstate), batch1(obs), _t(meas)[None], 0.1,
        torch.tensor([0.0, 0.0, -9.81]), tc.camera, tc.vio, True,
        key=_t(key)[None])
    assert int(jaux.n_match) >= 30                 # a healthy frame
    for f in ("n_desc", "n_match", "n_ins", "flags"):
        assert int(getattr(taux, f)[0]) == int(getattr(jaux, f)), f
    assert bool(tok[0]) == bool(jok)
    for f in ("map_valid", "map_age", "map_obs", "kf_ptr", "kf_obs_slot",
              "kf_obs_valid", "lost", "n_tracked", "next_slot"):
        assert np.array_equal(getattr(tnew, f)[0].numpy(),
                              np.asarray(getattr(jnew, f))), f
    assert np.array_equal(interop.to_numpy_tree(tnew.map_desc[0]),
                          np.asarray(jnew.map_desc))
    np.testing.assert_allclose(tnew.pos[0].numpy(), np.asarray(jnew.pos),
                               atol=1e-4)
    np.testing.assert_allclose(tnew.q[0].numpy(), np.asarray(jnew.q),
                               atol=1e-4)
    np.testing.assert_allclose(tnew.map_xyz[0].numpy(),
                               np.asarray(jnew.map_xyz), atol=1e-4)
    # the pose emitted to the relay
    jt_, jq_ = jtr.emit_slam_pose(jnew, jcfg.camera)
    tt_, tq_ = ttr.emit_slam_pose(tnew, tc.camera)
    np.testing.assert_allclose(tt_[0].numpy(), np.asarray(jt_), atol=1e-4)
    np.testing.assert_allclose(tq_[0].numpy(), np.asarray(jq_), atol=1e-4)


def test_duplicate_index_scatter_last_row_wins():
    """``x.at[idx].set(v)`` with repeated indices: XLA on the CPU applies
    the rows in order (the last wins); the port's ``_set_last`` pins the
    same order on every device."""
    rng = np.random.RandomState(0)
    idx = rng.randint(0, 20, (3, 256))
    vals = rng.normal(size=(3, 256, 3)).astype(np.float32)
    base = rng.normal(size=(3, 20, 3)).astype(np.float32)
    want = np.asarray(jax.vmap(lambda b, i, v: b.at[i].set(v))(
        base, idx, vals))
    got = ttr._set_last(torch.from_numpy(base), torch.from_numpy(idx),
                        torch.from_numpy(vals))
    assert np.array_equal(got.numpy(), want)
    # and the case the tracker meets: an unmatched row (old value) after
    # a matched row (refined value) on the same slot keeps the old value
    idx = torch.tensor([[4, 4]])
    got = ttr._set_last(torch.zeros(1, 8), idx, torch.tensor([[1.0, 0.0]]))
    assert got[0, 4] == 0.0


def _smooth_drive(rng, B, S, blk):
    t = (blk * S + np.arange(S)) / 200.0
    x = 0.5 * t[None] * (1.0 + 0.1 * np.arange(B)[:, None])
    y = 0.1 * np.sin(t)[None] + 0.0 * x
    pos = np.stack([x, y, 0.01 * x], -1).astype(np.float32)
    yaw = 0.2 * np.sin(0.5 * t)[None] + 0.0 * x
    q = np.stack([0 * yaw, 0 * yaw, np.sin(yaw / 2), np.cos(yaw / 2)], -1)
    return pos, q.astype(np.float32)


def test_imu_block_matches_jax():
    cfg = tcfg.DEFAULT.imu
    B, S = 3, 20
    keys = jax.random.split(jax.random.PRNGKey(4), B)
    jst = jax.vmap(lambda k: jimu.init_imu(k, cfg))(keys)
    tst = batched(jst)
    step = jax.jit(jax.vmap(lambda s, p, q, k: jimu.imu_block(
        s, p, q, 1 / 200.0, k, cfg)))
    rng = np.random.RandomState(0)
    for blk in range(4):
        pos, q = _smooth_drive(rng, B, S, blk)
        if blk == 2:
            pos[:] = pos[:, :1]                        # standstill
        k = jax.random.split(jax.random.PRNGKey(10 + blk), B)
        jst, jm = step(jst, pos, q, k)
        tst, tm = timu.imu_block(tst, _t(pos), _t(q), 1 / 200.0, _t(k),
                                 cfg)
        # components near zero: 1e-5 absolute
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6,
                                   atol=1e-5)
        for f in ("accel_n", "pos_n", "initialized"):
            assert np.array_equal(getattr(tst, f).numpy(),
                                  np.asarray(getattr(jst, f))), f
        np.testing.assert_allclose(tst.prev_omega.numpy(),
                                   np.asarray(jst.prev_omega), rtol=1e-6,
                                   atol=1e-5)


def test_preintegration_matches_jax():
    rng = np.random.RandomState(1)
    B, S = 4, 20
    acc = (rng.normal(0, 0.3, (B, S, 3)) + [0, 0, 9.81]).astype(np.float32)
    gyr = rng.normal(0, 0.2, (B, S, 3)).astype(np.float32)
    jp = jax.vmap(lambda a, g: jpre.integrate_block(
        jpre.empty_preint(), a, g, 0.005))(acc, gyr)
    tp = tpre.integrate_block(tpre.empty_preint(B, "cpu"), _t(acc), _t(gyr),
                              0.005)
    for f in ("dq", "dv", "dp", "dt"):
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(jp, f)), rtol=1e-6,
                                   atol=1e-6)
    pos = rng.normal(size=(B, 3)).astype(np.float32)
    vel = rng.normal(size=(B, 3)).astype(np.float32)
    q = rng.normal(size=(B, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    g = jnp.array([0.0, 0.0, -9.81])
    jout = jax.vmap(lambda p, v, qq, pre: jpre.propagate(p, v, qq, pre, g))(
        pos, vel, q, jp)
    tout = tpre.propagate(_t(pos), _t(vel), _t(q), tp,
                          torch.tensor([0.0, 0.0, -9.81]))
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


def test_drift_monitor_matches_jax():
    cfg = tcfg.DEFAULT.teach
    rng = np.random.RandomState(3)
    B = 3
    jst = jax.vmap(lambda _: jdm.init_drift_monitor(cfg))(jnp.arange(B))
    tst = tdm.init_drift_monitor(cfg, B)
    th = np.array([0.3, -1.2, 2.5])
    for i in range(700):
        gt = rng.normal(0, 20, (B, 2)).astype(np.float32) * 0 + i * 0.05
        gt[:, 1] += np.sin(i / 30.0) * (1 + np.arange(B))
        c, s = np.cos(th), np.sin(th)
        vio = np.stack([c * gt[:, 0] - s * gt[:, 1],
                        s * gt[:, 0] + c * gt[:, 1]], -1)
        vio = (vio * [[1, -1]] + rng.normal(0, 0.2 + 0.02 * i, (B, 2)))
        vio = vio.astype(np.float32)
        jst = jax.vmap(jdm.push_sample)(jst, vio, gt)
        tst = tdm.push_sample(tst, _t(vio), _t(gt))
        if i % 100 == 99:
            jst = jax.vmap(lambda s: jdm.check_drift(s, jnp.int32(i), cfg))(
                jst)
            tst = tdm.check_drift(tst, i, cfg)
            np.testing.assert_allclose(tst.drift_max.numpy(),
                                       np.asarray(jst.drift_max), rtol=1e-5)
            np.testing.assert_allclose(tst.drift_mean.numpy(),
                                       np.asarray(jst.drift_mean), rtol=1e-5)
            assert np.array_equal(tst.aborted.numpy(),
                                  np.asarray(jst.aborted))
    assert tst.aborted.any()                           # the gate fired
    np.testing.assert_array_equal(tst.n.numpy(), np.asarray(jst.n))
