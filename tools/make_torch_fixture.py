#!/usr/bin/env python3
"""Write the JAX reference traces the PyTorch port is held against on a GPU.

The GPU machine has no JAX, so the references for the port's campaigns are
recorded here with the JAX package (on the CPU) and committed as small
npz files, each of two real routes at full width — the 1850x950 map, 192x192
planning window, 80x60 depth rays, 256 live features — from the campaign
runners' default seeds:

- ``torch_gt_campaign_fixture.npz``: ``--teach-ticks`` GT-localized teach
  ticks (``config.gt_localization()`` with ``teach.run_vio=False``), then
  ``--repeat-ticks`` GT repeat ticks;
- ``torch_ours_campaign_fixture.npz``: ``OURS_TEACH_TICKS`` teach ticks
  with the live VIO (the ``gt_localization()`` default), waypoints from the
  aligned VIO track, then ``OURS_REPEAT_TICKS`` full-stack repeat ticks
  (``config.ours()``: VIO + anchors + v55 fusion);
- ``torch_rgbd_ba_campaign_fixture.npz``: off the same teach and waypoints,
  ``RGBD_BA_REPEAT_TICKS`` repeat ticks of the ``rgbd_ba`` mode (the
  baselines' ``rgbd_no_imu()`` — VIO without the inertial term, anchors,
  GT-stall watchdog — plus ``vio.enable_local_ba``: the sliding-window BA
  every tenth tick), with the keyframe ring and the VIO map it refined.

- ``torch_stock_campaign_fixture.npz`` and
  ``torch_encoder_campaign_fixture.npz``: off the same teach and waypoints,
  ``BASELINE_REPEAT_TICKS`` repeat ticks of the stock Nav2 baseline
  (``baselines.configs.stock_nav2()``: RPP, stock waypoint following with
  its one-time projection, VIO without anchors) and of the encoder-only
  ablation (``config.encoder_only()``), with the projected waypoints and
  the follower's final state.
- ``torch_rgbd_slam_fixture.npz``: the RGB-D SLAM baseline
  (``datasets/slam/rgbd_slam.py``) on the loop session of
  ``tests/test_rgbd_slam.py`` (72 pillars, 140 frames) with that test's run
  arguments: each frame's observed feature ids (the rows the matcher
  sees), the per-frame inlier counts, the loop candidates and accepted
  flags, the open and optimized poses.

- ``torch_cli_fixture.npz``: the command-line front ends at ``CLI_SCALE``
  (a 20 x 15 depth-ray grid, the full-width map and window):
  ``cli.campaign`` on ``CLI_ROUTES`` in the ``gt`` and ``ours`` modes with
  ``cli_argv``'s arguments (its traces.npz, metrics.json and standard
  output), and ``cli.teach`` then ``cli.repeat --mode ours`` on
  ``CLI_ROUTE`` (the bytes of every file they write).

- ``torch_slam_fixture.npz``: the LiDAR SLAM path, ``run_slam`` on the
  winter season of ``tools/slam_scale_test.py`` cut to ``SLAM_SCANS`` scans
  x ``SLAM_PTS`` points (on the tool's two laps, so that revisits fall on
  the first lap's scan positions and loops are accepted): the generator
  settings and a checksum of the scans (not the scans), the open and
  optimized poses, ICP RMSEs, loop pairs, detected and accepted flags, loop
  measurements, the RANSAC stage of each candidate's registration (the
  pose graph handed to the PGO is these and the chain's
  odometry edges), the junctions of its host-reduced graph and JAX's dense
  and interpret-mode K4 solutions of that.

- ``torch_benchmark_fixture.npz``: the dataset benchmark CLI
  (``cli/benchmark.py``) at its default seed: ``_run_session`` of the
  RobotCar dusk session (vision-only, with its drought windows) and of the
  4Seasons autumn session (visual-inertial), ``BENCH_TICKS`` ticks each,
  the sessions built as ``run_dataset`` builds them for that many ticks
  (``gt_xy``, ``gt_yaw``, ``vio_xy``, ``lost``, ``n_tracked``, ``gyro``,
  ``accel``); and what ``run_dataset`` writes for each dataset at
  ``BENCH_SMALL_TICKS`` ticks: the JSON and markdown texts, the files of
  its output tree with each one's first line and line count.

``chip_smoke.py`` replays the same campaigns and sessions on the card and
compares.  The tool writes every file, or those of the modes named
(``--mode slam gt ours rgbd_ba stock encoder rgbd_slam cli benchmark``;
ours, rgbd_ba, stock and encoder share the ours teach):

    JAX_PLATFORMS=cpu python tools/make_torch_fixture.py [--mode stock ...]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
DATA = REPO / "tests" / "data"
GT_OUT = DATA / "torch_gt_campaign_fixture.npz"
OURS_OUT = DATA / "torch_ours_campaign_fixture.npz"
RGBD_BA_OUT = DATA / "torch_rgbd_ba_campaign_fixture.npz"
SLAM_OUT = DATA / "torch_slam_fixture.npz"
STOCK_OUT = DATA / "torch_stock_campaign_fixture.npz"
ENCODER_OUT = DATA / "torch_encoder_campaign_fixture.npz"
RGBD_SLAM_OUT = DATA / "torch_rgbd_slam_fixture.npz"
CLI_OUT = DATA / "torch_cli_fixture.npz"
BENCH_OUT = DATA / "torch_benchmark_fixture.npz"
ROUTES = ("02_north_forest", "13_cross_nws")
# two routes whose first landmark block survives the repeat session's
# appearance death (LandmarkConfig.session_dead_frac), so that anchors
# publish inside the window
OURS_ROUTES = ("06_nw_ne", "09_se_ne")
# long enough for the relay to commit, the robots to leave the startup hold
# and anchors to publish inside the repeat window
OURS_TEACH_TICKS = 150
OURS_REPEAT_TICKS = 150
# long enough for at least MIN_BA_SOLVES local-BA ticks (tick % 10 == 3) that
# find three keyframes in a route's ring; run in chunks of BA_PERIOD ticks so
# that the ring can be read before each of them
RGBD_BA_REPEAT_TICKS = 150
BA_PERIOD = 10
MIN_BA_SOLVES = 5
# the baselines' repeats off the ours teach
BASELINE_REPEAT_TICKS = 150
# the RGB-D SLAM session's run arguments (tests/test_rgbd_slam.py)
RGBD_SLAM_KW = dict(loop_min_gap=60, sig_thresh=0.08)


# the SLAM session: the scale tool's winter season, cut in scans and points
SLAM_SCANS = 401
SLAM_PTS = 128
SLAM_LAPS = 2.0
SLAM_WORLD_SEED = 11
SLAM_SCAN_SEED = 17
SLAM_KW = dict(loop_min_gap=SLAM_SCANS // 8, sc_thresh=0.35, max_loops=64,
               sc_max_range=50.0)


def write_slam(out: Path):
    import jax

    sys.path.insert(0, str(REPO / "tools"))
    import slam_scale_test as tool
    from torch_slam_scale_test import slam_checksum
    from nclt_slam_tpu.datasets.slam import loop_closure, pipeline
    from nclt_slam_tpu.ops.pgo_pallas import optimize_pgo_pallas

    rng = np.random.RandomState(SLAM_WORLD_SEED)
    world = tool.build_world(rng)
    xy, yaw = tool.loop_trajectory(SLAM_SCANS, laps=SLAM_LAPS)
    srng = np.random.RandomState(SLAM_SCAN_SEED)
    scans, valid = tool.make_scans(*world, xy, yaw, srng, n_pts=SLAM_PTS,
                                   **tool.SEASONS[0][1])
    odom = tool.noisy_odom(xy, yaw, srng)

    seen = {}
    fast = loop_closure.optimize_pose_graph_fast

    def keep_graph(graph, **kw):
        seen["graph"] = jax.tree_util.tree_map(np.asarray, graph)
        return fast(graph, **kw)

    loop_closure.optimize_pose_graph_fast = keep_graph
    try:
        res = pipeline.run_slam(scans, valid, odom_pred=odom, **SLAM_KW)
    finally:
        loop_closure.optimize_pose_graph_fast = fast
    # the detector's flags before registration (one RANSAC key each), as
    # run_slam computes them
    descs = jax.vmap(lambda s, v: loop_closure.scan_context(
        s, v, max_range=SLAM_KW["sc_max_range"]))(scans, valid)
    _, _, detected = loop_closure.detect_loops_scalable(
        descs, res["poses_open"][:, :2], np.ones(SLAM_SCANS, bool),
        min_gap=SLAM_KW["loop_min_gap"], sc_thresh=SLAM_KW["sc_thresh"],
        max_loops=SLAM_KW["max_loops"])
    graph = seen["graph"]
    li, lj, found = res["loops"]
    if int(found.sum()) < 10:
        raise SystemExit(f"only {int(found.sum())} loops accepted")
    # the RANSAC stage of every detected candidate's registration, with
    # run_slam's keys (PRNGKey(0), split once per candidate)
    from nclt_slam_tpu.datasets.slam.registration import ransac_registration

    ransac = jax.jit(ransac_registration)
    L = len(li)
    ransac_R = np.zeros((L, 3, 3), np.float32)
    ransac_t = np.zeros((L, 3), np.float32)
    ransac_n = np.zeros(L, np.int32)
    ransac_ok = np.zeros(L, bool)
    key = jax.random.PRNGKey(0)
    for e in np.flatnonzero(np.asarray(detected)):
        key, k = jax.random.split(key)
        i, j = int(li[e]), int(lj[e])
        R, t, n, ok = ransac(scans[j], valid[j], scans[i], valid[i], k)
        ransac_R[e], ransac_t[e], ransac_n[e], ransac_ok[e] = R, t, n, ok
    reduced, red_w, junctions = loop_closure.reduce_pose_graph(graph, 1.0)
    dense = loop_closure._optimize_reduced_jit(reduced, red_w, 15, 10.0,
                                               1e-3)
    k4 = optimize_pgo_pallas(reduced, red_w, iters=15, interpret=True)
    np.savez_compressed(
        out,
        scans=SLAM_SCANS, pts=SLAM_PTS, laps=SLAM_LAPS,
        world_seed=SLAM_WORLD_SEED, scan_seed=SLAM_SCAN_SEED,
        season=np.asarray(tool.SEASONS[0][0]),
        run_kw=np.asarray(repr(SLAM_KW)),
        checksum=np.asarray(slam_checksum(scans, valid, odom)),
        poses_open=res["poses_open"].astype(np.float32),
        poses_optimized=res["poses_optimized"].astype(np.float32),
        rmses=np.asarray(res["rmses"], np.float32),
        loop_i=li, loop_j=lj, found=found,
        detected=np.asarray(detected),
        loop_meas=graph.loop_meas, ransac_R=ransac_R, ransac_t=ransac_t,
        ransac_n=ransac_n, ransac_ok=ransac_ok,
        junctions=junctions, red_dense=np.asarray(dense),
        red_k4_interpret=np.asarray(k4))


def slice_config(cfg_mod):
    base = cfg_mod.gt_localization()
    return base.replace(teach=dataclasses.replace(base.teach, run_vio=False))


def write_gt(cfg_mod, campaign, teach_ticks, repeat_ticks, out: Path):
    cfg = slice_config(cfg_mod)
    data = campaign.build_campaign(list(ROUTES), cfg=cfg)
    teach = campaign.run_campaign_teach(data, cfg, teach_ticks,
                                        stop_when_done=False)
    wps, n_wps = campaign.teach_waypoints(data, teach, cfg)
    rep = campaign.run_campaign_repeat(data, teach.teach_grid, wps, n_wps,
                                       cfg, repeat_ticks,
                                       stop_when_done=False)
    grid = np.asarray(teach.teach_grid)
    occupied = [np.flatnonzero(g == 2).astype(np.int32) for g in grid]
    np.savez_compressed(
        out,
        routes=np.asarray(ROUTES),
        teach_gt_xy=np.asarray(teach.trace.gt_xy),
        teach_gt_yaw=np.asarray(teach.trace.gt_yaw),
        teach_done=np.asarray(teach.trace.done),
        teach_free_cells=(grid == 0).sum((1, 2)),
        teach_occupied_idx=np.concatenate(occupied),
        teach_occupied_n=np.asarray([len(o) for o in occupied]),
        store_count=np.asarray(teach.store.count),
        wps=np.asarray(wps), n_wps=np.asarray(n_wps),
        repeat_gt_xy=np.asarray(rep.trace.gt_xy),
        repeat_gt_yaw=np.asarray(rep.trace.gt_yaw),
        repeat_wp_idx=np.asarray(rep.trace.wp_idx),
        repeat_done=np.asarray(rep.trace.done),
        repeat_fired=np.asarray(rep.trace.fired),
        repeat_plan_fails=np.asarray(rep.trace.plan_fails))


def ours_teach(cfg_mod, campaign, teach_ticks):
    """The teach that the ours and the rgbd_ba repeats share: (data, teach
    result, VIO waypoints, their counts)."""
    teach_cfg = cfg_mod.gt_localization()        # teach.run_vio=True
    data = campaign.build_campaign(list(OURS_ROUTES), cfg=teach_cfg)
    teach = campaign.run_campaign_teach(data, teach_cfg, teach_ticks,
                                        stop_when_done=False)
    wps, n_wps = campaign.teach_waypoints(data, teach, cfg_mod.ours())
    return data, teach, wps, n_wps                # source="vio"


def repeat_fields(r, final):
    return dict(
        repeat_gt_xy=np.asarray(r.gt_xy), repeat_nav_xy=np.asarray(r.nav_xy),
        repeat_regime=np.asarray(r.regime),
        repeat_anchor_ok=np.asarray(r.anchor_ok),
        repeat_anchor_reason=np.asarray(r.anchor_reason),
        repeat_anchor_inliers=np.asarray(r.anchor_inliers),
        repeat_vio_tracked=np.asarray(r.vio_tracked),
        repeat_wp_idx=np.asarray(r.wp_idx), repeat_done=np.asarray(r.done),
        repeat_committed=np.asarray(final.fusion.committed))


def write_ours(cfg_mod, campaign, shared, repeat_ticks, out: Path):
    data, teach, wps, n_wps = shared
    rep = campaign.run_campaign_repeat(data, teach.teach_grid, wps, n_wps,
                                       cfg_mod.ours(), repeat_ticks,
                                       stores=teach.store,
                                       stop_when_done=False)
    t = teach.trace
    np.savez_compressed(
        out,
        routes=np.asarray(OURS_ROUTES),
        teach_gt_xy=np.asarray(t.gt_xy), teach_vio_xy=np.asarray(t.vio_xy),
        teach_done=np.asarray(t.done),
        teach_vio_tracked=np.asarray(t.vio_tracked),
        store_count=np.asarray(teach.store.count),
        wps=np.asarray(wps), n_wps=np.asarray(n_wps),
        **repeat_fields(rep.trace, rep.final))


def write_rgbd_ba(campaign, shared, repeat_ticks, out: Path):
    import jax

    from nclt_slam_tpu.baselines.configs import rgbd_no_imu

    base = rgbd_no_imu()
    cfg = base.replace(vio=dataclasses.replace(base.vio,
                                               enable_local_ba=True))
    data, teach, wps, n_wps = shared
    carry, traces, kf_before_ba = None, [], []
    for t0 in range(0, repeat_ticks, BA_PERIOD):
        rep = campaign.run_campaign_repeat(
            data, teach.teach_grid, wps, n_wps, cfg, BA_PERIOD,
            stores=teach.store, chunk=BA_PERIOD, carry=carry, tick0=t0,
            stop_when_done=False)
        # the ring as the chunk's local-BA tick (t0 + 3) can at least count
        # on: keyframes are only added in between
        if carry is not None:
            kf_before_ba.append(np.asarray(carry.vio.kf_valid).sum(1))
        carry = rep.final
        traces.append(rep.trace)
    r = jax.tree_util.tree_map(lambda *x: np.concatenate(x, 1), *traces)
    kf_before_ba = np.stack(kf_before_ba, 1)        # (routes, chunks - 1)
    n_solves = (kf_before_ba >= 3).sum(1)
    if n_solves.max() < MIN_BA_SOLVES:
        raise SystemExit(f"only {n_solves.tolist()} local-BA ticks found "
                         f"three keyframes: lengthen RGBD_BA_REPEAT_TICKS")
    vio = carry.vio
    np.savez_compressed(
        out,
        routes=np.asarray(OURS_ROUTES),
        wps=np.asarray(wps), n_wps=np.asarray(n_wps),
        repeat_vio_xy=np.asarray(r.vio_xy),
        kf_before_ba=kf_before_ba,
        final_kf_valid=np.asarray(vio.kf_valid),
        final_kf_ptr=np.asarray(vio.kf_ptr),
        final_kf_pos=np.asarray(vio.kf_pos),
        final_kf_quat=np.asarray(vio.kf_quat),
        final_map_valid=np.asarray(vio.map_valid),
        final_map_xyz=np.asarray(vio.map_xyz),
        **repeat_fields(r, carry))


def baseline_fields(r, final, wps, n_wps):
    """A baseline repeat's traces, the waypoints it ran on (after the stock
    projection) and its follower's final state."""
    out = repeat_fields(r, final)
    out.update(
        repeat_vio_xy=np.asarray(r.vio_xy), repeat_cmd_v=np.asarray(r.cmd_v),
        repeat_goal_blocked=np.asarray(r.goal_blocked),
        repeat_plan_fails=np.asarray(r.plan_fails),
        repeat_recovery_phase=np.asarray(r.recovery_phase),
        run_wps=np.asarray(wps), run_n_wps=np.asarray(n_wps))
    out.update({f"final_ctrl_{f}": np.asarray(v)
                for f, v in zip(final.ctrl._fields, final.ctrl)})
    return out


def write_baseline(cfg, campaign, shared, repeat_ticks, out: Path):
    data, teach, wps, n_wps = shared
    rep = campaign.run_campaign_repeat(data, teach.teach_grid, wps, n_wps,
                                       cfg, repeat_ticks, stores=teach.store,
                                       stop_when_done=False)
    run_wps, run_n = campaign.apply_stock_projection(teach.teach_grid, wps,
                                                     n_wps, cfg)
    np.savez_compressed(
        out, routes=np.asarray(OURS_ROUTES),
        wps=np.asarray(wps), n_wps=np.asarray(n_wps),
        **baseline_fields(rep.trace, rep.final, run_wps, run_n))


def write_rgbd_slam(out: Path):
    sys.path.insert(0, str(REPO / "tests"))
    from test_rgbd_slam import CFG, _loop_session
    from nclt_slam_tpu.datasets.slam.rgbd_slam import run_rgbd_slam

    obs_seq, gt = _loop_session()
    res = run_rgbd_slam(obs_seq, CFG.camera, **RGBD_SLAM_KW)
    li, lj, accepted = res.loops
    np.savez_compressed(
        out, run_kw=np.asarray(repr(RGBD_SLAM_KW)), gt_xy=gt,
        feat_id=np.stack([np.asarray(o.feat_id) for o in obs_seq]),
        valid=np.stack([np.asarray(o.valid) for o in obs_seq]),
        n_matches=res.n_matches, poses_open=res.poses_open,
        poses_opt=res.poses_opt, loop_i=np.asarray(li),
        loop_j=np.asarray(lj), loop_accepted=np.asarray(accepted))


# the command-line front ends: two routes for the campaign CLI, one for the
# single-route teach -> repeat CLIs; the teach is long enough for two
# waypoints a route (the GT repeat reaches both), the ours repeat stays
# inside the relay's startup hold
CLI_ROUTES = ("01_road", "08_nw_sw")
CLI_ROUTE = "08_nw_sw"
CLI_TEACH_TICKS = 60
CLI_REPEAT_TICKS = 30
CLI_SCALE = 0.25
CLI_TEACH_FILES = ("teach_map.pgm", "teach_map.yaml", "landmarks.pkl",
                   "vio_pose_dense.csv", "traj_gt.csv")
CLI_REPEAT_FILES = ("traj_gt.csv", "nav_pose.csv", "metrics.json")


def cli_argv(mode: str, out) -> list:
    """``cli.campaign``'s arguments for the fixture (either package)."""
    return ["--routes", ",".join(CLI_ROUTES), "--mode", mode,
            "--out", str(out), "--teach-ticks", str(CLI_TEACH_TICKS),
            "--repeat-ticks", str(CLI_REPEAT_TICKS),
            "--scale", str(CLI_SCALE)]


def teach_argv(out) -> list:
    return ["--route", CLI_ROUTE, "--out", str(out),
            "--ticks", str(CLI_TEACH_TICKS), "--scale", str(CLI_SCALE)]


def repeat_argv(teach_dir, out) -> list:
    return ["--route", CLI_ROUTE, "--teach-dir", str(teach_dir),
            "--out", str(out), "--mode", "ours",
            "--ticks", str(CLI_REPEAT_TICKS), "--scale", str(CLI_SCALE)]


def write_cli(out: Path):
    """The JAX package's CLIs run in-process: for each campaign mode, its
    traces.npz arrays (``MODE_trace_KEY``), metrics.json text and standard
    output; the single-route teach and repeat directories' files as bytes
    (``teach/NAME``, ``repeat/NAME``) and the teach directory's path, which
    teach_map.yaml names."""
    import contextlib
    import io
    import tempfile

    from nclt_slam_tpu.cli import campaign as jcampaign
    from nclt_slam_tpu.cli import repeat as jrepeat
    from nclt_slam_tpu.cli import teach as jteach

    arrays = {}
    with tempfile.TemporaryDirectory() as tmp:
        for mode in ("gt", "ours"):
            d = Path(tmp) / mode
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                jcampaign.main(cli_argv(mode, d))
            arrays[f"{mode}_stdout"] = np.asarray(buf.getvalue())
            arrays[f"{mode}_metrics"] = np.asarray(
                (d / "metrics.json").read_text())
            with np.load(d / "traces.npz") as z:
                arrays.update({f"{mode}_trace_{k}": z[k] for k in z.files})
        td, rd = Path(tmp) / "teach", Path(tmp) / "repeat"
        jteach.main(teach_argv(td))
        jrepeat.main(repeat_argv(td, rd))
        for d, tag, names in ((td, "teach", CLI_TEACH_FILES),
                              (rd, "repeat", CLI_REPEAT_FILES)):
            for name in names:
                arrays[f"{tag}/{name}"] = np.frombuffer(
                    (d / name).read_bytes(), np.uint8)
        arrays["teach_dir"] = np.asarray(str(td))
    np.savez_compressed(out, **arrays)


# the dataset benchmark: the replayed sessions' ticks, and a run_dataset
# just past _evaluate's 100 settle ticks
BENCH_TICKS = 150
BENCH_SMALL_TICKS = 105
BENCH_SEED = 11
BENCH_SESSIONS = (("robotcar", "dusk"), ("4seasons", "autumn"))


def bench_sessions(jb, n_ticks: int, seed: int = BENCH_SEED):
    """``run_dataset``'s sessions, drawn in its order: {dataset: (route,
    world, {session: (cond_keep, use_imu)}, cfg)}."""
    from nclt_slam_tpu import config as cfg_mod

    out = {}
    for dataset in ("robotcar", "4seasons"):
        rng = np.random.default_rng(seed)
        if dataset == "robotcar":
            route = jb._loop_route(834.0, rng)
            world = jb._facade_world(route, rng)
            sessions = {
                "overcast": (jb._condition_windows(n_ticks, rng, 1,
                                                   keep=0.15), False),
                "dusk": (jb._condition_windows(n_ticks, rng, 5, frac_lo=0.04,
                                               frac_hi=0.09, keep=0.03),
                         False)}
            cfg = cfg_mod.rgbd_no_imu()
        else:
            route = jb._loop_route(700.0, rng, aspect=0.6, wobble=9.0)
            world = jb._facade_world(route, rng, offset=8.0, every=5.0,
                                     radius=0.9)
            sessions = {
                "spring": (np.ones(n_ticks, np.float32), True),
                "autumn": (jb._condition_windows(n_ticks, rng, 1,
                                                 frac_lo=0.01, frac_hi=0.02,
                                                 keep=0.3), True)}
            cfg = cfg_mod.ours()
        out[dataset] = (route, world, sessions, cfg)
    return out


def write_benchmark(out: Path):
    import contextlib
    import io
    import tempfile

    from nclt_slam_tpu.cli import benchmark as jb

    arrays = dict(ticks=np.int32(BENCH_TICKS), seed=np.int32(BENCH_SEED),
                  small_ticks=np.int32(BENCH_SMALL_TICKS))
    setup = bench_sessions(jb, BENCH_TICKS)
    for dataset, session in BENCH_SESSIONS:
        route, world, sessions, cfg = setup[dataset]
        ck, use_imu = sessions[session]
        tr = jb._run_session(route, world, ck, use_imu, cfg, BENCH_TICKS,
                             chunk=BENCH_TICKS, seed=BENCH_SEED)
        arrays[f"{dataset}/{session}/cond_keep"] = ck
        for name, value in tr._asdict().items():
            arrays[f"{dataset}/{session}/{name}"] = np.asarray(value)
    with tempfile.TemporaryDirectory() as tmp:
        for dataset in ("robotcar", "4seasons"):
            d = Path(tmp)
            with contextlib.redirect_stdout(io.StringIO()):
                jb.run_dataset(dataset, d, BENCH_SMALL_TICKS, "cpu",
                               export=True, seed=BENCH_SEED)
            arrays[f"run/{dataset}_bench.json"] = np.asarray(
                (d / f"{dataset}_bench.json").read_text())
            arrays[f"run/{dataset}_bench.md"] = np.asarray(
                (d / f"{dataset}_bench.md").read_text())
        files = sorted(str(p.relative_to(tmp)) for p in Path(tmp).rglob("*")
                       if p.is_file())
        arrays["run/files"] = np.asarray(files)
        lines = [(Path(tmp) / f).read_text().splitlines() for f in files]
        arrays["run/first_lines"] = np.asarray([ln[0] if ln else ""
                                                for ln in lines])
        arrays["run/n_lines"] = np.asarray([len(ln) for ln in lines])
        arrays["run/tmp"] = np.asarray(str(tmp))
    np.savez_compressed(out, **arrays)


MODES = ("slam", "gt", "ours", "rgbd_ba", "stock", "encoder", "rgbd_slam",
         "cli", "benchmark")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--teach-ticks", type=int, default=100)
    ap.add_argument("--repeat-ticks", type=int, default=100)
    ap.add_argument("--mode", nargs="+", choices=("all",) + MODES,
                    default=["all"], help="the fixtures to write")
    args = ap.parse_args(argv)
    modes = set(MODES) if "all" in args.mode else set(args.mode)

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")
    from nclt_slam_tpu import config as cfg_mod
    from nclt_slam_tpu.baselines import configs as baselines
    from nclt_slam_tpu.rollout import campaign

    DATA.mkdir(parents=True, exist_ok=True)

    def wrote(out):
        print(f"wrote {out} ({out.stat().st_size} bytes)", flush=True)

    if "slam" in modes:
        write_slam(SLAM_OUT)
        wrote(SLAM_OUT)
    if "gt" in modes:
        write_gt(cfg_mod, campaign, args.teach_ticks, args.repeat_ticks,
                 GT_OUT)
        wrote(GT_OUT)
    if modes & {"ours", "rgbd_ba", "stock", "encoder"}:
        shared = ours_teach(cfg_mod, campaign, OURS_TEACH_TICKS)
        if "ours" in modes:
            write_ours(cfg_mod, campaign, shared, OURS_REPEAT_TICKS,
                       OURS_OUT)
            wrote(OURS_OUT)
        if "rgbd_ba" in modes:
            write_rgbd_ba(campaign, shared, RGBD_BA_REPEAT_TICKS,
                          RGBD_BA_OUT)
            wrote(RGBD_BA_OUT)
        for mode, cfg, out in (("stock", baselines.stock_nav2(), STOCK_OUT),
                               ("encoder", cfg_mod.encoder_only(),
                                ENCODER_OUT)):
            if mode in modes:
                write_baseline(cfg, campaign, shared, BASELINE_REPEAT_TICKS,
                               out)
                wrote(out)
    if "rgbd_slam" in modes:
        write_rgbd_slam(RGBD_SLAM_OUT)
        wrote(RGBD_SLAM_OUT)
    if "cli" in modes:
        write_cli(CLI_OUT)
        wrote(CLI_OUT)
    if "benchmark" in modes:
        write_benchmark(BENCH_OUT)
        wrote(BENCH_OUT)


if __name__ == "__main__":
    main()
