#!/usr/bin/env python3
"""Per-stage cost of the ours repeat tick on the card — the port's
counterpart of ``tools/profile_stages.py``.

Builds the 15-route (or ``--routes`` N) ours campaign at full width,
teaches ``--teach-ticks`` ticks (GT relay config with the live VIO, as
``cli.campaign``), repeats ``--warm`` ticks through the campaign runner
(past the relay's startup hold: committed relays, live costmaps, filled
VIO maps), then calls each stage of ``rollout/repeat.py:repeat_step``
alone on the inputs that tick gives it, in the tick's order:

    turnaround supervisor, diff-drive substeps, IMU block, observe,
    vio_frame, match_tick (2 Hz), fusion_tick, costmap (2 Hz: render_depth,
    integrate_depth, the inflated window), dispatch_plan (2 Hz), coarse
    potential (at the replan cadence), dispatch_move, follower

and the whole tick (calls of ``TICKS_A_CALL`` consecutive ticks from the
warm carry, so that every 2 Hz phase is in the mean).  Each stage's result
feeds the next, and before any timing the chain is held against one
``repeat_step`` call on the warm carry (``check_against_step``): a change to
the tick's wiring that the stages do not follow stops the tool.  For each
stage it reports:

- ``ms``: ms a call between two CUDA events around ``--iters`` calls (the
  stream's wall time: the card's work and its idle gaps while the host
  issues);
- ``host_us``: the host's µs a call, issuing the same calls with no
  synchronisation inside the loop;
- ``launches``: kernel launches a call (``cudaLaunchKernel`` and
  ``cudaLaunchKernelExC`` events of ``torch.profiler`` over one call) and
  ``device_ms``, the card's busy ms in that call;
- ``per_tick_ms``: ``ms`` over the stage's cadence period.

The profiled calls run after every timed one: once the profiler has
attached to the CUDA driver, launches stay slower for the rest of the process.
On the card (the default):

    python3 tools/torch_profile_stages.py --out runs/profile_stages.json

``--device cpu`` rehearses it on the CPU at a cut size (``--routes 2
--teach-ticks 20 --warm 5 --iters 2``): host times only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# the full-tick row runs this many consecutive ticks a call (a multiple of
# the 2 Hz cadence) and reports a tick's share of them
TICKS_A_CALL = 10


def card_line(dev) -> str:
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def time_stage(fn, iters: int, dev) -> dict:
    """ms a call (CUDA events, or the host clock on the CPU) and host µs a
    call of ``fn`` after one warm-up call."""
    import torch
    fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    sync(dev)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        ms = (time.perf_counter() - t0) / iters * 1e3
    return {"ms": ms, "host_us": host_s / iters * 1e6}


def profile_stage(fn, dev) -> dict:
    """Kernel launches and the card's busy ms of one call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(dev)
    with profile(activities=acts) as prof:
        fn()
        sync(dev)
    ka = prof.key_averages()
    launches = sum(e.count for e in ka
                   if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"))
    busy_us = sum(e.self_device_time_total for e in ka
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return {"launches": launches, "device_ms": busy_us * 1e-3}


def warm_state(n_routes: int, teach_ticks: int, warm: int, dev):
    """(cfg, data, teach result, warm carry, next tick)."""
    from nclt_slam_tpu_torch.cli.common import config_for
    from nclt_slam_tpu_torch.rollout import campaign
    from nclt_slam_tpu_torch.scene.routes import ALL_ROUTES

    cfg_teach, cfg = config_for("gt"), config_for("ours")
    data = campaign.build_campaign(ALL_ROUTES[:n_routes], cfg=cfg,
                                   device=dev)
    teach = campaign.run_campaign_teach(data, cfg_teach, teach_ticks,
                                        stop_when_done=False)
    wps, n_wps = campaign.teach_waypoints(data, teach, cfg)
    rep = campaign.run_campaign_repeat(data, teach.teach_grid, wps, n_wps,
                                       cfg, warm, stores=teach.store,
                                       stop_when_done=False)
    sync(dev)
    n_chunks, chunk = campaign.planned_chunks(warm, 250)
    return cfg, data, teach, rep.final, n_chunks * chunk


def stages(cfg, data, teach, carry, tick: int):
    """([(name, cadence period, fn)], composed) — each stage of
    ``repeat_step`` on the inputs the warm carry gives it at ``tick``, in
    the tick's order, and the chained stages' results that
    ``check_against_step`` holds against the tick's.  Rows whose name
    starts with two spaces are parts of the stage above."""
    import torch

    from nclt_slam_tpu_torch.control.pure_pursuit import follower_tick
    from nclt_slam_tpu_torch.control.supervisor import supervisor_tick
    from nclt_slam_tpu_torch.core import prng
    from nclt_slam_tpu_torch.dynamics.diffdrive import nav_substeps, robot_pose3d
    from nclt_slam_tpu_torch.fusion.relay import anchor_update, fusion_tick, select_routes
    from nclt_slam_tpu_torch.landmarks.matcher import match_tick
    from nclt_slam_tpu_torch.mapping.occupancy import (
        crop_window,
        inflate_cost,
        integrate_depth,
        occupancy_trinary,
        world_to_cell,
    )
    from nclt_slam_tpu_torch.planning.dispatcher import dispatch_move, dispatch_plan
    from nclt_slam_tpu_torch.planning.wavefront import coarse_potential, coarse_traversal
    from nclt_slam_tpu_torch.rollout.repeat import repeat_step
    from nclt_slam_tpu_torch.rollout.teach import GRAVITY, _scene_features
    from nclt_slam_tpu_torch.scene.terrain import terrain_height
    from nclt_slam_tpu_torch.sensors.depth import (
        cam_points_to_world,
        depth_to_cam_points,
        render_depth,
    )
    from nclt_slam_tpu_torch.sensors.features import observe
    from nclt_slam_tpu_torch.sensors.imu import imu_block
    from nclt_slam_tpu_torch.vio.tracker import emit_slam_pose, vio_frame

    scene, route, store = data.scenes_repeat, data.routes, teach.store
    teach_grid = teach.teach_grid
    dev = carry.cmd.device
    B = carry.cmd.shape[0]
    _, k_dyn, k_obs, k_match, k_fuse, k_vio = \
        prng.split(carry.key, 6).unbind(1)
    gravity = torch.tensor(GRAVITY, device=dev)
    dt_frame = cfg.sim.nav_decimation / cfg.sim.physics_hz

    # the inputs each stage sees, computed once as repeat_step does; each
    # stage's own result feeds the next, and check_against_step holds the
    # chain against one repeat_step call
    sup = supervisor_tick(carry.sup, carry.robot.xy, route.turnaround,
                          cfg.supervisor)
    valid_now = scene.valid & ~(scene.drop_mask & sup.fired[:, None])
    robot, (pos_traj, quat_traj) = nav_substeps(
        carry.robot, carry.cmd[:, 0], carry.cmd[:, 1], scene.xy,
        scene.radius, valid_now, k_dyn, cfg.sim)
    pos3, _ = robot_pose3d(robot)
    _, imu_meas = imu_block(carry.imu, pos_traj, quat_traj,
                            1.0 / cfg.sim.physics_hz, k_fuse, cfg.imu)
    occluders = (scene.xy, scene.radius, scene.base_z, scene.height,
                 valid_now & scene.drop_mask,
                 torch.arange(scene.xy.shape[1], dtype=torch.int32,
                              device=dev))
    feats = _scene_features(scene)

    def do_observe():
        return observe(pos3, robot.yaw, feats, valid_now, k_obs, cfg.camera,
                       cfg.landmarks, yaw_rate=carry.cmd[:, 1],
                       occluders=occluders,
                       px_session_amp=cfg.camera.px_bias_session_amp)

    obs = do_observe()

    def do_vio():
        return vio_frame(carry.vio, obs, imu_meas, dt_frame, gravity,
                         cfg.camera, cfg.vio, cfg.mode.use_imu, key=k_vio)

    vio, slam_ok, _ = do_vio()
    slam_t, slam_q = emit_slam_pose(vio, cfg.camera)
    slam_ok = slam_ok & torch.isfinite(slam_t).all(-1) & \
        torch.isfinite(slam_q).all(-1)
    query = torch.cat([robot.xy, torch.zeros_like(robot.yaw)[:, None]], -1)
    drought_s = (tick - carry.fusion.anchor_tick).clamp_min(0).to(
        torch.float32) * 0.1
    extra = torch.clamp_max(
        cfg.landmarks.consistency_relax_per_s * drought_s,
        cfg.landmarks.consistency_relax_max_m)

    def do_match():
        res = match_tick(store, obs, robot.xy, robot.yaw, query, k_match,
                         cfg.camera, cfg.landmarks, consistency_extra_m=extra)
        return select_routes(res.ok, anchor_update(
            carry.fusion, res.xy, res.std, tick, cfg.fusion), carry.fusion)

    fusion_in = do_match() if tick % cfg.landmarks.tick_period == 0 \
        else carry.fusion

    def do_fusion():
        return fusion_tick(fusion_in, robot.xy[:, 0], robot.xy[:, 1],
                           robot.yaw, slam_t, slam_q, slam_ok, tick, k_fuse,
                           cfg.encoder, cfg.fusion)

    fusion, nav_x, nav_y, nav_yaw, _ = do_fusion()
    nav_xy = torch.stack([nav_x, nav_y], -1)

    def do_render():
        return render_depth(pos3, robot.yaw, scene.xy, scene.radius,
                            scene.base_z, scene.height, valid_now,
                            cfg.camera)

    depth, _, dvalid = do_render()

    def do_integrate():
        p_cam = depth_to_cam_points(depth, cfg.camera)
        nav_pos3 = torch.cat([nav_xy, (terrain_height(
            nav_xy[:, 0], nav_xy[:, 1]) + 0.13)[:, None]], -1)
        pts = cam_points_to_world(p_cam, nav_pos3, nav_yaw, cfg.camera)
        return integrate_depth(carry.grid_live, nav_xy,
                               pts.reshape(B, -1, 3), dvalid.reshape(B, -1),
                               cfg.map)

    grid_new = do_integrate()

    def do_window():
        r, c = world_to_cell(nav_xy[:, 0], nav_xy[:, 1], cfg.map)
        live_win, r0, c0 = crop_window(grid_new, r, c, cfg.planner.window)
        teach_win, _, _ = crop_window(teach_grid, r, c, cfg.planner.window)
        occ = torch.maximum(occupancy_trinary(live_win, cfg.map), teach_win)
        return inflate_cost(occ, cfg.map), r0, c0

    def do_costmap():
        do_render()
        do_integrate()
        return do_window()

    update, replan = cfg.map.update_period, cfg.planner.replan_period
    grid_live = grid_new
    if tick % update == 0:
        cost_win, win_r0, win_c0 = do_window()
    else:
        grid_live = carry.grid_live
        cost_win, win_r0, win_c0 = carry.cost_win, carry.win_r0, carry.win_c0

    def do_coarse():
        tc = coarse_traversal(teach_grid, cfg.map, cfg.planner)
        return coarse_potential(tc, carry.dispatch.target, cfg.map,
                                cfg.planner)

    coarse_phi, coarse_goal = carry.coarse_phi, carry.coarse_goal
    if cfg.planner.coarse_seed and tick % replan == 1:
        coarse_phi, coarse_goal = do_coarse(), carry.dispatch.target
    drop_active = scene.drop_mask & valid_now

    def do_plan():
        return dispatch_plan(
            carry.dispatch, nav_xy, cost_win, win_r0, win_c0, scene.xy,
            scene.radius, drop_active, cfg.map, cfg.planner, tick,
            coarse_phi=coarse_phi if cfg.planner.coarse_seed else None,
            coarse_goal=coarse_goal)

    planned = do_plan() if tick % update == 0 else carry.dispatch

    def do_move():
        return dispatch_move(planned, nav_xy, scene.xy, scene.radius,
                             drop_active, cfg.planner)

    dispatch = do_move()
    t_now = torch.full((), tick, dtype=torch.float32, device=dev) * 0.1

    def do_follow():
        d = dispatch
        return follower_tick(
            carry.ctrl, nav_xy, nav_yaw, d.path_xy, d.n_path,
            d.has_path & ~d.done, d.plan_version, cost_win, win_r0, win_c0,
            t_now, cfg.map, cfg.control, cfg.planner.window)

    _, v, w = do_follow()
    stop = dispatch.done | ((~fusion.committed) if
                            tick < cfg.fusion.startup_hold_ticks else False)
    composed = {
        "sup.fired": sup.fired, "robot.xy": robot.xy, "robot.yaw": robot.yaw,
        "vio.n_tracked": vio.n_tracked, "nav_xy": nav_xy,
        "fusion.committed": fusion.committed, "grid_live": grid_live,
        "cost_win": cost_win, "coarse_phi": coarse_phi,
        "dispatch.n_path": dispatch.n_path,
        "dispatch.path_xy": dispatch.path_xy, "dispatch.idx": dispatch.idx,
        "cmd": torch.where(stop[:, None], torch.zeros_like(v)[:, None],
                           torch.stack([v, w], -1)),
    }
    state = {"carry": carry, "tick": tick}

    def do_ticks():
        for _ in range(TICKS_A_CALL):
            state["carry"], _ = repeat_step(state["carry"], state["tick"],
                                            scene, route, teach_grid, store,
                                            cfg)
            state["tick"] += 1

    return [
        ("full tick", 1, do_ticks),
        ("turnaround supervisor", 1, lambda: supervisor_tick(
            carry.sup, carry.robot.xy, route.turnaround, cfg.supervisor)),
        ("diff-drive substeps", 1, lambda: nav_substeps(
            carry.robot, carry.cmd[:, 0], carry.cmd[:, 1], scene.xy,
            scene.radius, valid_now, k_dyn, cfg.sim)),
        ("IMU block", 1, lambda: imu_block(
            carry.imu, pos_traj, quat_traj, 1.0 / cfg.sim.physics_hz,
            k_fuse, cfg.imu)),
        ("observe", 1, do_observe),
        ("vio_frame", 1, do_vio),
        ("match_tick", cfg.landmarks.tick_period, do_match),
        ("fusion_tick", 1, do_fusion),
        ("costmap", update, do_costmap),
        ("  render_depth", update, do_render),
        ("  integrate_depth", update, do_integrate),
        ("  crop+trinary+inflate", update, do_window),
        ("dispatch_plan", update, do_plan),
        ("coarse potential", replan, do_coarse),
        ("dispatch_move", 1, do_move),
        ("follower", 1, do_follow),
    ], composed


def check_against_step(cfg, data, teach, carry, tick: int, composed: dict):
    """Hold the stages' chained results against one ``repeat_step`` call
    on the same carry, so that the stages are timed on the inputs the tick
    gives them: integers and flags exactly, floats within 1e-5 (the
    costmap's scatter-add may sum in another order on the card).  Raises
    on the first field that differs."""
    import torch

    from nclt_slam_tpu_torch.rollout.repeat import repeat_step

    new, trace = repeat_step(carry, tick, data.scenes_repeat, data.routes,
                             teach.teach_grid, teach.store, cfg)
    want = {
        "sup.fired": new.sup.fired, "robot.xy": new.robot.xy,
        "robot.yaw": new.robot.yaw, "vio.n_tracked": new.vio.n_tracked,
        "nav_xy": trace.nav_xy, "fusion.committed": new.fusion.committed,
        "grid_live": new.grid_live, "cost_win": new.cost_win,
        "coarse_phi": new.coarse_phi, "dispatch.n_path": new.dispatch.n_path,
        "dispatch.path_xy": new.dispatch.path_xy,
        "dispatch.idx": new.dispatch.idx, "cmd": new.cmd,
    }
    assert list(want) == list(composed)
    for name, a in want.items():
        b = composed[name]
        same = (torch.allclose(a, b, rtol=1e-5, atol=1e-5)
                if a.is_floating_point() else torch.equal(a, b))
        if not same:
            raise AssertionError(
                f"stage input {name} differs from repeat_step's at tick "
                f"{tick}: the stages no longer compose the tick")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--routes", type=int, default=15)
    ap.add_argument("--teach-ticks", type=int, default=200)
    ap.add_argument("--warm", type=int, default=60,
                    help="repeat ticks before the stages are measured")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="JSON output path")
    args = ap.parse_args(argv)

    import torch

    import nclt_slam_tpu_torch  # noqa: F401  (sets the TF32 switches)
    from nclt_slam_tpu_torch.rollout.campaign import campaign_device

    dev = campaign_device(args.device)
    if dev.type == "cuda":
        from nclt_slam_tpu_torch.ops import hamming, wavefront
        for m in (hamming, wavefront):
            m._load()
    card = card_line(dev)
    t0 = time.perf_counter()
    cfg, data, teach, carry, tick = warm_state(
        args.routes, args.teach_ticks, args.warm, dev)
    warm_s = time.perf_counter() - t0
    rows, composed = stages(cfg, data, teach, carry, tick)
    check_against_step(cfg, data, teach, carry, tick, composed)
    print(f"the stages' chained results equal repeat_step's at tick {tick}")
    timed = {name: time_stage(fn, args.iters, dev) for name, _, fn in rows}
    counted = {name: profile_stage(fn, dev) for name, _, fn in rows}

    out = []
    for name, period, _ in rows:
        r = {"stage": name.strip(), "part": name.startswith("  "),
             "period": period, **timed[name], **counted[name]}
        if name == "full tick":
            for k in ("ms", "host_us", "launches", "device_ms"):
                r[k] /= TICKS_A_CALL
        r["per_tick_ms"] = r["ms"] / period
        out.append(r)
    whole = [r for r in out if r["stage"] != "full tick" and not r["part"]]
    print(f"card: {card}; {args.routes} routes, warm carry after "
          f"{args.teach_ticks} teach + {args.warm} repeat ticks "
          f"({warm_s:.1f} s); {args.iters} calls a timing")
    print(f"{'stage':26s} {'period':>6s} {'ms/call':>9s} {'host us':>9s} "
          f"{'launches':>9s} {'dev ms':>8s} {'ms/tick':>9s}")
    for r in out:
        label = ("  " if r["part"] else "") + r["stage"]
        print(f"{label:26s} {r['period']:6d} {r['ms']:9.3f} "
              f"{r['host_us']:9.1f} {r['launches']:9.1f} "
              f"{r['device_ms']:8.3f} {r['per_tick_ms']:9.3f}")
    sums = {k: sum(r[k] / r["period"] for r in whole)
            for k in ("ms", "launches", "device_ms")}
    print(f"{'sum of stages':26s} {'':6s} {'':9s} {'':9s} "
          f"{sums['launches']:9.1f} {sums['device_ms']:8.3f} "
          f"{sums['ms']:9.3f}   (per tick)")
    if args.out:
        p = Path(args.out)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps({
            "card": card, "routes": args.routes,
            "teach_ticks": args.teach_ticks, "warm_ticks": args.warm,
            "iters": args.iters, "torch": torch.__version__,
            "stages": out, "sum_per_tick": sums}, indent=1))
        print(f"wrote {p}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
