"""Repeat pass: the navigation inner loop (``nclt_slam_tpu/rollout/repeat.py``).

Stage cadences match the reference: dynamics at 200 Hz (substeps), control
at 10 Hz, costmap + planner at 2 Hz, the coarse full-map potential at the
5 s replan cadence, supervisor continuous.  Within a tick, dynamics
advances with the previous command; the localization source yields the nav
pose; the costmap/planner/dispatcher/follower produce the next command.
The route batch is the leading dimension; cadence gates are host-side
``if``s, per-route predicates ``torch.where`` masks.

The localization source is selected by ``cfg.mode``: ``use_gt`` passes GT
straight through; otherwise the 200 Hz IMU block runs and the v55 relay
fuses what the stack gives it.  ``use_slam`` adds the feature observation
(the dropped obstacles as occluders) and ``vio_frame`` (with IMU, or with
constant-velocity prediction under ``use_imu=False``), and holds the robot
at spawn until the relay has committed its SLAM alignment; ``use_anchors``
adds the anchor matcher at 2 Hz.  Without SLAM (the encoder-only ablation)
the relay runs on encoder plus compass; with neither SLAM nor anchors the
feature observation is skipped (its key is split off before the branch,
so every other draw is the same as when it runs).
``VioConfig.enable_local_ba`` adds the sliding-window BA (kernel K3) every
tenth tick, ``PlannerConfig.gt_stall_abort`` the baselines' GT-stall
watchdog, ``ControlConfig.use_rpp`` the stock RegulatedPurePursuit
follower with its recovery cycle in place of the thesis follower, and
``PlannerConfig.stock_follow`` the stock waypoint-following semantics of
the dispatcher (``config`` presets: ``encoder_only()``,
``baselines.configs.stock_nav2()``).

Like the JAX package, the IMU block and the relay draw from the same
``k_fuse`` key of a tick.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nclt_slam_tpu_torch.config import Config
from nclt_slam_tpu_torch.control.pure_pursuit import CtrlState, follower_tick, init_ctrl
from nclt_slam_tpu_torch.control.rpp import RppState, init_rpp, rpp_tick
from nclt_slam_tpu_torch.control.supervisor import (
    SupervisorState,
    init_supervisor,
    supervisor_tick,
)
from nclt_slam_tpu_torch.core import prng
from nclt_slam_tpu_torch.dynamics.diffdrive import (
    RobotState,
    init_robot,
    nav_substeps,
    robot_pose3d,
)
from nclt_slam_tpu_torch.fusion.relay import (
    FusionState,
    anchor_update,
    fusion_tick,
    init_fusion,
    select_routes,
)
from nclt_slam_tpu_torch.landmarks.matcher import match_tick
from nclt_slam_tpu_torch.landmarks.store import LandmarkStore, init_store
from nclt_slam_tpu_torch.mapping.occupancy import (
    crop_window,
    empty_grid,
    inflate_cost,
    integrate_depth,
    occupancy_trinary,
    world_to_cell,
)
from nclt_slam_tpu_torch.planning.dispatcher import (
    DispatchState,
    dispatch_move,
    dispatch_plan,
    init_dispatch,
)
from nclt_slam_tpu_torch.planning.wavefront import coarse_potential, coarse_traversal
from nclt_slam_tpu_torch.rollout.scene_pack import PackedRoute, PackedScene
from nclt_slam_tpu_torch.rollout.teach import GRAVITY, _scene_features, stack_trace
from nclt_slam_tpu_torch.scene.terrain import terrain_height
from nclt_slam_tpu_torch.sensors.depth import (
    cam_points_to_world,
    depth_to_cam_points,
    render_depth,
)
from nclt_slam_tpu_torch.sensors.features import observe
from nclt_slam_tpu_torch.sensors.imu import ImuState, imu_block, init_imu
from nclt_slam_tpu_torch.vio.tracker import (
    VioState,
    emit_body_pos,
    emit_slam_pose,
    init_vio,
    local_ba,
    vio_frame,
)


class RepeatCarry(NamedTuple):
    robot: RobotState
    ctrl: CtrlState | RppState
    dispatch: DispatchState
    sup: SupervisorState
    imu: ImuState
    vio: VioState
    fusion: FusionState
    grid_live: torch.Tensor    # (B, rows, cols) live obstacle-layer log-odds
    cost_win: torch.Tensor     # (B, W, W) cached inflated costmap window
    win_r0: torch.Tensor       # (B,) int32
    win_c0: torch.Tensor       # (B,) int32
    coarse_phi: torch.Tensor   # (B, Rc, Cc) level-1 cost-to-goal potential
    coarse_goal: torch.Tensor  # (B, 2) the goal coarse_phi was computed for
    gt_hist: torch.Tensor      # (B, 18, 2) GT ring buffer (baseline watchdog)
    cmd: torch.Tensor          # (B, 2) v, w applied next tick
    key: torch.Tensor          # (B, 2)


class RepeatTrace(NamedTuple):
    gt_xy: torch.Tensor
    gt_yaw: torch.Tensor
    nav_xy: torch.Tensor       # localization output fed to nav
    regime: torch.Tensor       # fusion regime code (-1 under GT)
    anchor_ok: torch.Tensor
    anchor_reason: torch.Tensor
    anchor_shift: torch.Tensor
    anchor_inliers: torch.Tensor
    vio_xy: torch.Tensor
    vio_tracked: torch.Tensor
    vio_ndesc: torch.Tensor
    vio_nins: torch.Tensor
    vio_flags: torch.Tensor
    wp_idx: torch.Tensor
    cmd_v: torch.Tensor
    done: torch.Tensor
    fired: torch.Tensor
    goal_blocked: torch.Tensor
    plan_fails: torch.Tensor
    recovery_phase: torch.Tensor


class RepeatResult(NamedTuple):
    trace: RepeatTrace
    final: RepeatCarry


def repeat_step(carry: RepeatCarry, tick: int, scene: PackedScene,
                route: PackedRoute, teach_grid, store: LandmarkStore | None,
                cfg: Config):
    """One 10 Hz repeat tick for the whole route batch.  ``store`` (the
    teach landmarks, stacked per route) is read by the anchor matcher."""
    key, k_dyn, k_obs, k_match, k_fuse, k_vio = \
        prng.split(carry.key, 6).unbind(1)
    t_now = torch.full((), tick, dtype=torch.float32,
                       device=carry.cmd.device) * 0.1
    f32, i32 = torch.float32, torch.int32
    B = carry.cmd.shape[0]
    dev = carry.cmd.device
    mode = cfg.mode

    # --- supervisor decides the current collider set (GT-based poll) ---
    sup = supervisor_tick(carry.sup, carry.robot.xy, route.turnaround,
                          cfg.supervisor)
    valid_now = scene.valid & ~(scene.drop_mask & sup.fired[:, None])

    # --- dynamics: apply the previous tick's command ---
    robot, (pos_traj, quat_traj) = nav_substeps(
        carry.robot, carry.cmd[:, 0], carry.cmd[:, 1], scene.xy,
        scene.radius, valid_now, k_dyn, cfg.sim)
    gt_yaw = robot.yaw
    pos3, _ = robot_pose3d(robot)

    # --- localization ---
    neg = torch.full((B,), -1, dtype=i32, device=dev)
    zero_i = torch.zeros(B, dtype=i32, device=dev)
    anchor_ok = torch.zeros(B, dtype=torch.bool, device=dev)
    anchor_reason, anchor_inliers = neg, zero_i
    anchor_shift = torch.zeros(B, dtype=f32, device=dev)
    vio_aux = None
    if mode.use_gt:
        imu, vio, fusion = carry.imu, carry.vio, carry.fusion
        nav_xy, nav_yaw = robot.xy, gt_yaw
        regime = neg
    else:
        # 200 Hz synthetic IMU over this tick's substep trajectory
        imu, imu_meas = imu_block(carry.imu, pos_traj, quat_traj,
                                  1.0 / cfg.sim.physics_hz, k_fuse, cfg.imu)
        if mode.use_slam or mode.use_anchors:
            # dropped obstacles block the line of sight to teach features
            occluders = (scene.xy, scene.radius, scene.base_z, scene.height,
                         valid_now & scene.drop_mask,
                         torch.arange(scene.xy.shape[1], dtype=i32,
                                      device=dev))
            obs = observe(pos3, robot.yaw, _scene_features(scene), valid_now,
                          k_obs, cfg.camera, cfg.landmarks,
                          yaw_rate=carry.cmd[:, 1], occluders=occluders,
                          px_session_amp=cfg.camera.px_bias_session_amp)
        if mode.use_slam:
            vio, slam_ok, vio_aux = vio_frame(
                carry.vio, obs, imu_meas,
                cfg.sim.nav_decimation / cfg.sim.physics_hz,
                torch.tensor(GRAVITY, device=dev), cfg.camera, cfg.vio,
                mode.use_imu, key=k_vio)
            # local sliding-window BA at 1 Hz
            if cfg.vio.enable_local_ba and tick % 10 == 3:
                vio = local_ba(vio, cfg.camera, cfg.vio)
            slam_t, slam_q = emit_slam_pose(vio, cfg.camera)
            slam_ok = slam_ok & torch.isfinite(slam_t).all(-1) & \
                torch.isfinite(slam_q).all(-1)
        else:
            # encoder + compass dead reckoning: the relay sees no SLAM pose
            vio = carry.vio
            slam_ok = torch.zeros(B, dtype=torch.bool, device=dev)
            slam_t = torch.zeros(B, 3, dtype=f32, device=dev)
            slam_q = torch.tensor([0.0, 0.0, 0.0, 1.0],
                                  device=dev).expand(B, 4)

        # --- visual anchor matcher at 2 Hz, gated on GT like the
        # reference matcher reading the sim's pose file ---
        fusion = carry.fusion
        if mode.use_anchors and tick % cfg.landmarks.tick_period == 0:
            drought_s = (tick - fusion.anchor_tick).clamp_min(0).to(f32) * 0.1
            extra = torch.clamp_max(
                cfg.landmarks.consistency_relax_per_s * drought_s,
                cfg.landmarks.consistency_relax_max_m)
            query = torch.cat([robot.xy, torch.zeros_like(gt_yaw)[:, None]],
                              -1)
            res = match_tick(store, obs, robot.xy, gt_yaw, query, k_match,
                             cfg.camera, cfg.landmarks,
                             consistency_extra_m=extra)
            fusion = select_routes(res.ok, anchor_update(
                fusion, res.xy, res.std, tick, cfg.fusion), fusion)
            anchor_ok, anchor_reason = res.ok, res.reason
            anchor_shift = torch.linalg.vector_norm(res.xy - robot.xy, dim=-1)
            anchor_inliers = res.n_inliers

        # --- v55 relay fusion tick ---
        fusion, nav_x, nav_y, nav_yaw, regime = fusion_tick(
            fusion, robot.xy[:, 0], robot.xy[:, 1], gt_yaw, slam_t, slam_q,
            slam_ok, tick, k_fuse, cfg.encoder, cfg.fusion)
        nav_xy = torch.stack([nav_x, nav_y], -1)

    # --- sensing + costmap at 2 Hz ---
    grid_live = carry.grid_live
    cost_win, win_r0, win_c0 = carry.cost_win, carry.win_r0, carry.win_c0
    if tick % cfg.map.update_period == 0:
        # the camera senses reality (true pose), but points are placed in
        # the map through the NAV pose, like Nav2's TF of /depth_points
        depth, _, dvalid = render_depth(
            pos3, robot.yaw, scene.xy, scene.radius, scene.base_z,
            scene.height, valid_now, cfg.camera)
        p_cam = depth_to_cam_points(depth, cfg.camera)
        nav_pos3 = torch.cat([nav_xy, (terrain_height(nav_xy[:, 0],
                                                      nav_xy[:, 1])
                                       + 0.13)[:, None]], -1)
        pts = cam_points_to_world(p_cam, nav_pos3, nav_yaw, cfg.camera)
        grid_live = integrate_depth(grid_live, nav_xy, pts.reshape(B, -1, 3),
                                    dvalid.reshape(B, -1), cfg.map)
        r, c = world_to_cell(nav_xy[:, 0], nav_xy[:, 1], cfg.map)
        # crop first: the trinary map and the max with the teach map are
        # elementwise, so only the window is converted
        live_win, win_r0, win_c0 = crop_window(grid_live, r, c,
                                               cfg.planner.window)
        teach_win, _, _ = crop_window(teach_grid, r, c, cfg.planner.window)
        occ_win = torch.maximum(occupancy_trinary(live_win, cfg.map),
                                teach_win)
        cost_win = inflate_cost(occ_win, cfg.map)

    # --- level-1 plan: full-map coarse potential toward the current target,
    # refreshed at the replan cadence; it seeds the window border ---
    coarse_phi, coarse_goal = carry.coarse_phi, carry.coarse_goal
    if cfg.planner.coarse_seed and tick % cfg.planner.replan_period == 1:
        tc_coarse = coarse_traversal(teach_grid, cfg.map, cfg.planner)
        coarse_phi = coarse_potential(tc_coarse, carry.dispatch.target,
                                      cfg.map, cfg.planner)
        coarse_goal = carry.dispatch.target

    drop_active = scene.drop_mask & valid_now
    dispatch = carry.dispatch
    if tick % cfg.map.update_period == 0:
        dispatch = dispatch_plan(
            dispatch, nav_xy, cost_win, win_r0, win_c0, scene.xy,
            scene.radius, drop_active, cfg.map, cfg.planner, tick,
            coarse_phi=coarse_phi if cfg.planner.coarse_seed else None,
            coarse_goal=coarse_goal)

    # --- dispatcher cheap phase ---
    dispatch = dispatch_move(dispatch, nav_xy, scene.xy, scene.radius,
                             drop_active, cfg.planner)

    # --- baseline GT-stall watchdog: a run whose GROUND TRUTH moves less
    # than gt_stall_min_m inside the window ends at the first sustained
    # stall.  Ring-sampled GT bounding box over the window; fires only
    # after the warm-up (the bring-up hold parks the robot legitimately) ---
    gt_hist = carry.gt_hist
    if cfg.planner.gt_stall_abort:
        W_h = gt_hist.shape[1]
        period = cfg.planner.gt_stall_window_ticks // W_h
        if tick % period == 0:
            at = torch.arange(W_h, device=dev) == (tick // period) % W_h
            gt_hist = torch.where(at[None, :, None], robot.xy[:, None],
                                  gt_hist)
        if tick >= max(cfg.planner.gt_stall_window_ticks,
                       cfg.planner.gt_stall_warmup_ticks):
            span = torch.linalg.vector_norm(
                gt_hist.amax(1) - gt_hist.amin(1), dim=-1)
            dispatch = dispatch._replace(
                done=dispatch.done | (span < cfg.planner.gt_stall_min_m))

    # --- follower (thesis pure-pursuit stack or stock RPP baseline) ---
    path_active = dispatch.has_path & ~dispatch.done
    if cfg.control.use_rpp:
        ctrl, v, w = rpp_tick(
            carry.ctrl, nav_xy, nav_yaw, dispatch.path_xy, dispatch.n_path,
            path_active, t_now, cfg.rpp)
    else:
        ctrl, v, w = follower_tick(
            carry.ctrl, nav_xy, nav_yaw, dispatch.path_xy, dispatch.n_path,
            path_active, dispatch.plan_version, cost_win, win_r0, win_c0,
            t_now, cfg.map, cfg.control, cfg.planner.window)
    v = torch.where(dispatch.done, torch.zeros_like(v), v)
    w = torch.where(dispatch.done, torch.zeros_like(w), w)

    # --- stack bring-up hold: the robot sits at spawn until the relay has
    # committed its one-time SLAM alignment (bounded by the hold ticks) ---
    if mode.use_slam and not mode.use_gt and \
            tick < cfg.fusion.startup_hold_ticks:
        hold = ~fusion.committed
        v = torch.where(hold, torch.zeros_like(v), v)
        w = torch.where(hold, torch.zeros_like(w), w)

    has_aux = vio_aux is not None
    trace = RepeatTrace(
        gt_xy=robot.xy, gt_yaw=gt_yaw, nav_xy=nav_xy,
        regime=regime, anchor_ok=anchor_ok, anchor_reason=anchor_reason,
        anchor_shift=anchor_shift, anchor_inliers=anchor_inliers,
        vio_xy=(emit_body_pos(vio)[:, :2] if mode.use_slam
                else torch.zeros(B, 2, dtype=f32, device=dev)),
        vio_tracked=vio.n_tracked if not mode.use_gt else neg,
        vio_ndesc=vio_aux.n_desc if has_aux else neg,
        vio_nins=vio_aux.n_ins if has_aux else neg,
        vio_flags=vio_aux.flags if has_aux else zero_i,
        wp_idx=dispatch.idx, cmd_v=v, done=dispatch.done, fired=sup.fired,
        goal_blocked=dispatch.goal_blocked, plan_fails=dispatch.plan_fails,
        recovery_phase=ctrl.phase if cfg.control.use_rpp else neg)
    new_carry = RepeatCarry(
        robot=robot, ctrl=ctrl, dispatch=dispatch, sup=sup,
        imu=imu, vio=vio, fusion=fusion,
        grid_live=grid_live, cost_win=cost_win,
        win_r0=win_r0, win_c0=win_c0,
        coarse_phi=coarse_phi, coarse_goal=coarse_goal,
        gt_hist=gt_hist,
        cmd=torch.stack([v, w], -1), key=key)
    return new_carry, trace


def init_repeat_carry(route: PackedRoute, wps, n_wps, cfg: Config,
                      seed: int = 1) -> RepeatCarry:
    """Initial repeat state for a batch of packed routes and their teach
    waypoints (wps (B, max_waypoints, 2), n_wps (B,))."""
    B = route.spawn.shape[0]
    dev = route.spawn.device
    W = cfg.planner.window
    f = cfg.planner.coarse_factor
    Rc = -(-cfg.map.rows // f)
    Cc = -(-cfg.map.cols // f)
    k_imu, key = prng.split(prng.PRNGKey(seed, dev)).unbind(0)
    return RepeatCarry(
        robot=init_robot(route.spawn, route.spawn_yaw),
        ctrl=init_rpp(B, dev) if cfg.control.use_rpp else init_ctrl(B, dev),
        dispatch=init_dispatch(wps, n_wps, cfg.planner),
        sup=init_supervisor(B, dev),
        imu=init_imu(k_imu.expand(B, 2), cfg.imu),
        vio=init_vio(cfg.landmarks.desc_words, cfg.vio.window_kf, B, dev),
        fusion=init_fusion(cfg.fusion, B, dev),
        grid_live=empty_grid(cfg.map, B, dev),
        cost_win=torch.zeros(B, W, W, device=dev),
        win_r0=torch.zeros(B, dtype=torch.int32, device=dev),
        win_c0=torch.zeros(B, dtype=torch.int32, device=dev),
        coarse_phi=torch.full((B, Rc, Cc), 1e9, device=dev),
        coarse_goal=torch.full((B, 2), 1e9, device=dev),
        gt_hist=torch.zeros(B, 18, 2, device=dev),
        cmd=torch.zeros(B, 2, device=dev),
        key=key.expand(B, 2).clone(),
    )


def run_repeat(scene: PackedScene, route: PackedRoute, teach_grid, wps,
               n_wps, cfg: Config, n_ticks: int, seed: int = 1,
               store: LandmarkStore | None = None,
               carry: RepeatCarry | None = None,
               tick0: int = 0) -> RepeatResult:
    """Roll the repeat pass with the teach artefacts (map + waypoints);
    ``carry``/``tick0`` continue a previous chunk."""
    if carry is None:
        carry = init_repeat_carry(route, wps, n_wps, cfg, seed)
    if store is None:
        store = init_store(cfg.landmarks, route.spawn.shape[0],
                           route.spawn.device)
    rows = []
    for t in range(tick0, tick0 + n_ticks):
        carry, tr = repeat_step(carry, t, scene, route, teach_grid, store,
                                cfg)
        rows.append(tr)
    return RepeatResult(trace=stack_trace(RepeatTrace, rows), final=carry)
