"""The whole slice — GT-localized teach then GT repeat — against the JAX
package, from the same seed, on the miniature scene/route/config of
``tests/test_rollout_e2e.py``; a campaign build on two real routes; and the
port's no-JAX-at-runtime rule.

Tolerance: the two packages' float32 arithmetic differs in rounding (XLA
fuses multiply-adds and has its own transcendental functions), so the
poses agree to ~1e-6 m per tick; over 100 ticks the stated bound is 1e-3 m.
Every discrete outcome (waypoint index, done, supervisor fire, trinary map)
must be equal.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
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

from nclt_slam_tpu.rollout import campaign as jcamp  # noqa: E402
from nclt_slam_tpu.rollout.repeat import run_repeat as j_run_repeat  # noqa: E402
from nclt_slam_tpu.rollout.teach import run_teach as j_run_teach  # noqa: E402
from nclt_slam_tpu_torch import config as tcfg  # noqa: E402
from nclt_slam_tpu_torch import interop  # noqa: E402
from nclt_slam_tpu_torch.rollout import campaign as tcamp  # noqa: E402
from nclt_slam_tpu_torch.rollout.repeat import run_repeat as t_run_repeat  # noqa: E402
from nclt_slam_tpu_torch.rollout.teach import run_teach as t_run_teach  # noqa: E402

# the test workers share the CPU: one intra-op thread each keeps their
# torch thread pools from oversubscribing it
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TICKS = 100
POSE_ATOL = 1e-3


def port_small_config():
    """small_config() rebuilt from the port's own config tree."""
    j = small_config()
    base = tcfg.gt_localization()
    return base.replace(**{
        name: dataclasses.replace(getattr(base, name),
                                  **dataclasses.asdict(getattr(j, name)))
        for name in ("camera", "map", "planner", "teach")})


def batch1(tree):
    """A single-route JAX tree as a 1-route batch of the port."""
    return interop.from_numpy_tree(jax.tree_util.tree_map(
        lambda x: np.asarray(x)[None], tree), "cpu")


@pytest.fixture(scope="module")
def runs():
    cfg = small_config()
    tc = port_small_config()
    assert dataclasses.asdict(tc) == dataclasses.asdict(cfg)
    route = straight_route()
    packed, wps, n_wps = pack_test_route(route, cfg)
    teach_scene = tiny_scene(drop_on_path=False)
    jt = jax.jit(lambda: j_run_teach(teach_scene, packed, cfg, TICKS))()
    tt = t_run_teach(batch1(teach_scene), batch1(packed), tc, TICKS)
    rep_scene = tiny_scene(drop_on_path=True)
    jr = jax.jit(lambda: j_run_repeat(rep_scene, packed, jt.teach_grid, wps,
                                      n_wps, cfg, TICKS))()
    tr = t_run_repeat(batch1(rep_scene), batch1(packed),
                      torch.from_numpy(np.array(jt.teach_grid))[None],
                      torch.from_numpy(wps)[None],
                      torch.tensor([n_wps], dtype=torch.int32), tc, TICKS)
    return jt, tt, jr, tr


def test_teach_matches_jax(runs):
    jt, tt, _, _ = runs
    gt = np.asarray(jt.trace.gt_xy)
    assert np.hypot(*(gt[-1] - gt[0])) > 5.0      # the robot drove
    np.testing.assert_allclose(tt.trace.gt_xy[0].numpy(), gt, atol=POSE_ATOL)
    np.testing.assert_allclose(tt.trace.gt_yaw[0].numpy(),
                               np.asarray(jt.trace.gt_yaw), atol=POSE_ATOL)
    assert np.array_equal(tt.trace.done[0].numpy(), np.asarray(jt.trace.done))
    assert np.array_equal(tt.teach_grid[0].numpy(), np.asarray(jt.teach_grid))
    assert (np.asarray(jt.teach_grid) == 2).sum() > 0
    # the landmark recorder stored the same features
    js, ts = jt.store, tt.store
    assert int(js.count) >= 2
    assert np.array_equal(ts.count.numpy(), np.asarray(js.count)[None])
    assert np.array_equal(interop.to_numpy_tree(ts.desc[0]),
                          np.asarray(js.desc))
    assert np.array_equal(ts.feat_valid[0].numpy(), np.asarray(js.feat_valid))
    assert np.array_equal(interop.to_numpy_tree(tt.final.key[0]),
                          np.asarray(jt.final.key))
    # the IMU biases are the carry's first draws (normal: <= 4 ulps)
    np.testing.assert_allclose(tt.final.imu.bias_gyro[0].numpy(),
                               np.asarray(jt.final.imu.bias_gyro), rtol=1e-6)
    np.testing.assert_allclose(tt.final.imu.bias_accel[0].numpy(),
                               np.asarray(jt.final.imu.bias_accel), rtol=1e-6)


def _assert_trees_equal(port_tree, jax_tree, path=""):
    if hasattr(jax_tree, "_fields"):
        assert type(port_tree).__name__ == type(jax_tree).__name__, path
        for f in jax_tree._fields:
            _assert_trees_equal(getattr(port_tree, f), getattr(jax_tree, f),
                                f"{path}.{f}")
        return
    got = interop.to_numpy_tree(port_tree)
    want = np.asarray(jax_tree)[None]
    assert got.dtype == want.dtype and got.shape == want.shape, path
    assert np.array_equal(got, want), path


def test_initial_carries_match_jax_field_for_field():
    from nclt_slam_tpu.rollout.repeat import init_repeat_carry as j_init_rep
    from nclt_slam_tpu.rollout.teach import init_teach_carry as j_init_teach
    from nclt_slam_tpu_torch.rollout.repeat import init_repeat_carry
    from nclt_slam_tpu_torch.rollout.teach import init_teach_carry

    cfg, tc = small_config(), port_small_config()
    packed, wps, n_wps = pack_test_route(straight_route(), cfg)
    jteach = j_init_teach(packed, cfg)
    tteach = init_teach_carry(batch1(packed), tc)
    # the IMU biases are float draws (<= 4 ulps); everything else is exact
    for f in ("bias_gyro", "bias_accel"):
        np.testing.assert_allclose(getattr(tteach.imu, f)[0].numpy(),
                                   np.asarray(getattr(jteach.imu, f)),
                                   rtol=1e-6)
    imu = interop.from_numpy_tree(jax.tree_util.tree_map(
        lambda x: np.asarray(x)[None], jteach.imu), "cpu")
    _assert_trees_equal(tteach._replace(imu=imu), jteach)
    jrep = j_init_rep(packed, wps, n_wps, cfg)
    trep = init_repeat_carry(batch1(packed), torch.from_numpy(wps)[None],
                             torch.tensor([n_wps], dtype=torch.int32), tc)
    imu = interop.from_numpy_tree(jax.tree_util.tree_map(
        lambda x: np.asarray(x)[None], jrep.imu), "cpu")
    _assert_trees_equal(trep._replace(imu=imu), jrep)


def test_step_parity_from_a_shared_carry(runs):
    """Both packages continue the JAX repeat carry at tick 100."""
    _, _, jr, _ = runs
    cfg, tc = small_config(), port_small_config()
    packed, wps, n_wps = pack_test_route(straight_route(), cfg)
    rep_scene = tiny_scene(drop_on_path=True)
    teach_grid = np.array(runs[0].teach_grid)
    n = 20
    jnext = jax.jit(lambda c: j_run_repeat(
        rep_scene, packed, teach_grid, wps, n_wps, cfg, n, carry=c,
        tick0=TICKS))(jr.final)
    tnext = t_run_repeat(batch1(rep_scene), batch1(packed),
                         torch.from_numpy(teach_grid)[None],
                         torch.from_numpy(wps)[None],
                         torch.tensor([n_wps], dtype=torch.int32), tc, n,
                         carry=batch1(jr.final), tick0=TICKS)
    for f in ("wp_idx", "done", "fired", "plan_fails"):
        assert np.array_equal(getattr(tnext.trace, f)[0].numpy(),
                              np.asarray(getattr(jnext.trace, f))), f
    np.testing.assert_allclose(tnext.trace.gt_xy[0].numpy(),
                               np.asarray(jnext.trace.gt_xy), atol=1e-4)
    assert np.array_equal(interop.to_numpy_tree(tnext.final.key[0]),
                          np.asarray(jnext.final.key))


def test_repeat_matches_jax(runs):
    _, _, jr, tr = runs
    for f in ("wp_idx", "done", "fired", "plan_fails", "goal_blocked"):
        assert np.array_equal(getattr(tr.trace, f)[0].numpy(),
                              np.asarray(getattr(jr.trace, f))), f
    assert int(np.asarray(jr.trace.wp_idx)[-1]) >= 2   # waypoints reached
    np.testing.assert_allclose(tr.trace.gt_xy[0].numpy(),
                               np.asarray(jr.trace.gt_xy), atol=POSE_ATOL)
    np.testing.assert_allclose(tr.trace.gt_yaw[0].numpy(),
                               np.asarray(jr.trace.gt_yaw), atol=POSE_ATOL)
    # the planner state behind those decisions: the K2 potentials are exact
    # functions of the costmap, which itself agrees to rounding
    assert np.array_equal(tr.final.coarse_phi[0].numpy(),
                          np.asarray(jr.final.coarse_phi))
    np.testing.assert_allclose(tr.final.cost_win[0].numpy(),
                               np.asarray(jr.final.cost_win), atol=1e-4)
    np.testing.assert_allclose(tr.final.dispatch.path_xy[0].numpy(),
                               np.asarray(jr.final.dispatch.path_xy),
                               atol=POSE_ATOL)


def test_waypoints_and_metrics_match_jax(runs):
    jt, tt, jr, tr = runs
    cfg, tc = small_config(), port_small_config()
    packed, _, _ = pack_test_route(straight_route(), cfg)
    jdata = jcamp.CampaignData(None, None, jax.tree_util.tree_map(
        lambda x: np.asarray(x)[None], packed), ("straight",))
    tdata = tcamp.CampaignData(None, None, batch1(packed), ("straight",))
    jteach = jt._replace(trace=jax.tree_util.tree_map(
        lambda x: np.asarray(x)[None], jt.trace))
    tteach = tt._replace(trace=interop.to_numpy_tree(tt.trace))
    jw, jn = jcamp.teach_waypoints(jdata, jteach, cfg)
    tw, tn = tcamp.teach_waypoints(tdata, tteach, tc)
    assert np.array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=POSE_ATOL)
    jrep = jr._replace(trace=jax.tree_util.tree_map(
        lambda x: np.asarray(x)[None], jr.trace))
    trep = tr._replace(trace=interop.to_numpy_tree(tr.trace))
    jm = jcamp.campaign_metrics(jdata, jrep, jw, jn, cfg)
    tm = tcamp.campaign_metrics(tdata, trep, tw, tn, tc)
    assert jm[1].keys() == tm[1].keys()
    for k in ("routes", "reach", "return", "full_success"):
        assert jm[1][k] == tm[1][k], k
    for k in ("avg_coverage_pct", "avg_final_d"):
        np.testing.assert_allclose(tm[1][k], jm[1][k], atol=POSE_ATOL)


def test_build_campaign_matches_jax():
    names = ["02_north_forest", "13_cross_nws"]
    jd = jcamp.build_campaign(names)
    td = tcamp.build_campaign(names, device="cpu")
    assert td.names == tuple(names)
    for part in ("routes", "scenes_teach", "scenes_repeat"):
        jp, tp = getattr(jd, part), getattr(td, part)
        for f in jp._fields:
            a = np.asarray(getattr(jp, f))
            b = interop.to_numpy_tree(getattr(tp, f))
            assert a.shape == b.shape, (part, f)
            if f in ("base_z", "feat_xyz"):
                # terrain_height: XLA's sin/cos vs torch's
                np.testing.assert_allclose(b, a, rtol=0, atol=4e-6)
            else:
                assert np.array_equal(b, a), (part, f)


def test_build_campaign_runs_on_the_card_by_default():
    """No device named: the CUDA card, or an error without one — never a
    silent CPU campaign."""
    if torch.cuda.is_available():
        assert tcamp.campaign_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcamp.build_campaign(["01_road"])
    assert tcamp.campaign_device("cpu") == torch.device("cpu")


def test_port_runs_without_jax():
    code = (
        "import dataclasses, sys\n"
        "from nclt_slam_tpu_torch import config, interop\n"
        "from nclt_slam_tpu_torch.baselines import configs as baselines\n"
        "from nclt_slam_tpu_torch.core import lie, quat\n"
        "from nclt_slam_tpu_torch.eval import metrics\n"
        "from nclt_slam_tpu_torch.fusion import relay\n"
        "from nclt_slam_tpu_torch.landmarks import matcher\n"
        "from nclt_slam_tpu_torch.ops import ba as ops_ba, hamming, "
        "wavefront\n"
        "from nclt_slam_tpu_torch.vio import ba, drift_monitor, "
        "preintegration, tracker\n"
        "from nclt_slam_tpu_torch.rollout.campaign import build_campaign\n"
        "from nclt_slam_tpu_torch.rollout.repeat import init_repeat_carry, "
        "repeat_step\n"
        "from nclt_slam_tpu_torch.rollout.teach import init_teach_carry, "
        "teach_step\n"
        "import torch\n"
        "cfg = config.gt_localization()\n"
        "assert cfg.teach.run_vio\n"
        "data = build_campaign(['01_road'], cfg=cfg, device='cpu')\n"
        "carry = init_teach_carry(data.routes, cfg)\n"
        "carry, tr = teach_step(carry, 0, data.scenes_teach, data.routes, "
        "cfg)\n"
        "assert tr.gt_xy.shape == (1, 2) and int(tr.vio_tracked[0]) >= 0\n"
        "ours = config.ours()\n"
        "wps = torch.zeros(1, ours.planner.max_waypoints, 2)\n"
        "rc = init_repeat_carry(data.routes, wps, torch.tensor([1], "
        "dtype=torch.int32), ours)\n"
        "rc, rt = repeat_step(rc, 0, data.scenes_repeat, data.routes, "
        "torch.zeros(1, ours.map.rows, ours.map.cols, dtype=torch.int8), "
        "carry.store, ours)\n"
        "assert int(rt.anchor_reason[0]) >= 0 and int(rt.regime[0]) >= 0\n"
        "rb = baselines.rgbd_ba()\n"
        "assert rb.vio.enable_local_ba and rb.planner.gt_stall_abort\n"
        "rc = init_repeat_carry(data.routes, wps, torch.tensor([1], "
        "dtype=torch.int32), rb)\n"
        "solves = []\n"
        "orig = ba.solve_ba_plain\n"
        "ba.solve_ba_plain = lambda *a, **k: (solves.append(1), "
        "orig(*a, **k))[1]\n"
        "rc, rt = repeat_step(rc, 3, data.scenes_repeat, data.routes, "
        "torch.zeros(1, rb.map.rows, rb.map.cols, dtype=torch.int8), "
        "carry.store, rb)\n"
        "assert solves == [1] and torch.isfinite(rt.nav_xy).all()\n"
        "for cfg in (baselines.stock_nav2(), config.encoder_only()):\n"
        "    rc = init_repeat_carry(data.routes, wps, torch.tensor([1], "
        "dtype=torch.int32), cfg)\n"
        "    rc, rt = repeat_step(rc, 0, data.scenes_repeat, data.routes, "
        "torch.zeros(1, cfg.map.rows, cfg.map.cols, dtype=torch.int8), "
        "carry.store, cfg)\n"
        "    assert torch.isfinite(rt.nav_xy).all()\n"
        "    assert int(rt.recovery_phase[0]) == (0 if cfg.control.use_rpp "
        "else -1)\n"
        "from nclt_slam_tpu_torch.datasets.slam import rgbd_slam\n"
        "from nclt_slam_tpu_torch.control import rpp\n"
        "import numpy as np\n"
        "sys.path.insert(0, 'tools')\n"
        "import torch_slam_scale_test as slam_tool\n"
        "import torch_calibrate\n"
        "from nclt_slam_tpu_torch.datasets.slam import icp, loop_closure, "
        "pipeline, registration\n"
        "from nclt_slam_tpu_torch.ops import pgo\n"
        "rng = np.random.RandomState(3)\n"
        "world = slam_tool.build_world(rng, n_trees=160, extent=60.0)\n"
        "traj = slam_tool.loop_trajectory(40, radius=35.0, laps=1.3)\n"
        "scans, valid = slam_tool.make_scans(*world, *traj, rng, n_pts=64, "
        "max_range=30.0)\n"
        "out = pipeline.run_slam(scans, valid, odom_pred=slam_tool.noisy_odom("
        "*traj, rng), loop_min_gap=10, sc_thresh=0.4, max_loops=8, "
        "local_map_scans=10, device='cpu')\n"
        "assert np.isfinite(out['poses_optimized']).all()\n"
        "li, lj, found = out['loops']\n"
        "graph = pipeline.pose_graph(out['poses_open'], li, lj, "
        "np.zeros((len(li), 3)), found, 'cpu')\n"
        "fast = loop_closure.optimize_pose_graph_fast(graph, iters=3)\n"
        "assert fast.shape == (40, 3) and torch.isfinite(fast).all()\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m == 'nclt_slam_tpu' or m.startswith(('jax.', 'jaxlib', 'nclt_slam_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
