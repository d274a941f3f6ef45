"""Repeat pass: the navigation inner loop (``nclt_slam_tpu/rollout/repeat.py``).

Stage cadences match the reference: dynamics at 200 Hz (substeps), control
at 10 Hz, costmap + planner at 2 Hz, the coarse full-map potential at the
5 s replan cadence, supervisor continuous.  Within a tick, dynamics
advances with the previous command; the localization source yields the nav
pose; the costmap/planner/dispatcher/follower produce the next command.
The route batch is the leading dimension; cadence gates are host-side
``if``s, per-route predicates ``torch.where`` masks.

Only GT localization (``cfg.mode.use_gt``) is ported; the VIO, anchor and
fusion modes come with later slices of the port.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nclt_slam_tpu_torch.config import Config
from nclt_slam_tpu_torch.control.pure_pursuit import CtrlState, follower_tick, init_ctrl
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
from nclt_slam_tpu_torch.fusion.relay import FusionState, init_fusion
from nclt_slam_tpu_torch.landmarks.store import LandmarkStore
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
from nclt_slam_tpu_torch.rollout.teach import stack_trace
from nclt_slam_tpu_torch.scene.terrain import terrain_height
from nclt_slam_tpu_torch.sensors.depth import (
    cam_points_to_world,
    depth_to_cam_points,
    render_depth,
)
from nclt_slam_tpu_torch.sensors.imu import ImuState, init_imu
from nclt_slam_tpu_torch.vio.tracker import VioState, init_vio


class RepeatCarry(NamedTuple):
    robot: RobotState
    ctrl: CtrlState
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


def _check_ported(cfg: Config):
    if not cfg.mode.use_gt:
        raise NotImplementedError(
            "only GT localization (config.gt_localization()) is ported; "
            "the VIO/anchor/fusion and encoder modes come with later slices")
    if cfg.control.use_rpp:
        raise NotImplementedError(
            "ControlConfig.use_rpp (stock RPP baseline) comes with the stock "
            "slice of the port")
    if cfg.planner.gt_stall_abort:
        raise NotImplementedError(
            "PlannerConfig.gt_stall_abort (baseline watchdog) comes with the "
            "stock slice of the port")


def repeat_step(carry: RepeatCarry, tick: int, scene: PackedScene,
                route: PackedRoute, teach_grid, store: LandmarkStore | None,
                cfg: Config):
    """One 10 Hz repeat tick for the whole route batch.  ``store`` (the
    teach landmarks) is read only by the anchor matcher, which GT
    localization does not run."""
    _check_ported(cfg)
    key, k_dyn = prng.split(carry.key, 6)[:, :2].unbind(1)
    t_now = torch.full((), tick, dtype=torch.float32,
                       device=carry.cmd.device) * 0.1
    f32, i32 = torch.float32, torch.int32
    B = carry.cmd.shape[0]
    dev = carry.cmd.device

    # --- supervisor decides the current collider set (GT-based poll) ---
    sup = supervisor_tick(carry.sup, carry.robot.xy, route.turnaround,
                          cfg.supervisor)
    valid_now = scene.valid & ~(scene.drop_mask & sup.fired[:, None])

    # --- dynamics: apply the previous tick's command ---
    robot, _ = nav_substeps(carry.robot, carry.cmd[:, 0], carry.cmd[:, 1],
                            scene.xy, scene.radius, valid_now, k_dyn, cfg.sim)
    gt_yaw = robot.yaw
    pos3, _ = robot_pose3d(robot)

    # --- localization: GT straight through ---
    imu, vio, fusion = carry.imu, carry.vio, carry.fusion
    nav_xy, nav_yaw = robot.xy, gt_yaw

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

    # --- follower (thesis pure-pursuit stack) ---
    ctrl, v, w = follower_tick(
        carry.ctrl, nav_xy, nav_yaw, dispatch.path_xy, dispatch.n_path,
        dispatch.has_path & ~dispatch.done, dispatch.plan_version,
        cost_win, win_r0, win_c0, t_now, cfg.map, cfg.control,
        cfg.planner.window)
    v = torch.where(dispatch.done, torch.zeros_like(v), v)
    w = torch.where(dispatch.done, torch.zeros_like(w), w)

    neg = torch.full((B,), -1, dtype=i32, device=dev)
    zero_i = torch.zeros(B, dtype=i32, device=dev)
    trace = RepeatTrace(
        gt_xy=robot.xy, gt_yaw=gt_yaw, nav_xy=nav_xy,
        regime=neg, anchor_ok=torch.zeros(B, dtype=torch.bool, device=dev),
        anchor_reason=neg, anchor_shift=torch.zeros(B, dtype=f32, device=dev),
        anchor_inliers=zero_i,
        vio_xy=torch.zeros(B, 2, dtype=f32, device=dev),
        vio_tracked=neg, vio_ndesc=neg, vio_nins=neg, vio_flags=zero_i,
        wp_idx=dispatch.idx, cmd_v=v, done=dispatch.done, fired=sup.fired,
        goal_blocked=dispatch.goal_blocked, plan_fails=dispatch.plan_fails,
        recovery_phase=neg)
    new_carry = RepeatCarry(
        robot=robot, ctrl=ctrl, dispatch=dispatch, sup=sup,
        imu=imu, vio=vio, fusion=fusion,
        grid_live=grid_live, cost_win=cost_win,
        win_r0=win_r0, win_c0=win_c0,
        coarse_phi=coarse_phi, coarse_goal=coarse_goal,
        gt_hist=carry.gt_hist,
        cmd=torch.stack([v, w], -1), key=key)
    return new_carry, trace


def init_repeat_carry(route: PackedRoute, wps, n_wps, cfg: Config,
                      seed: int = 1) -> RepeatCarry:
    """Initial repeat state for a batch of packed routes and their teach
    waypoints (wps (B, max_waypoints, 2), n_wps (B,))."""
    _check_ported(cfg)
    B = route.spawn.shape[0]
    dev = route.spawn.device
    W = cfg.planner.window
    f = cfg.planner.coarse_factor
    Rc = -(-cfg.map.rows // f)
    Cc = -(-cfg.map.cols // f)
    k_imu, key = prng.split(prng.PRNGKey(seed, dev)).unbind(0)
    return RepeatCarry(
        robot=init_robot(route.spawn, route.spawn_yaw),
        ctrl=init_ctrl(B, dev),
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
    rows = []
    for t in range(tick0, tick0 + n_ticks):
        carry, tr = repeat_step(carry, t, scene, route, teach_grid, store,
                                cfg)
        rows.append(tr)
    return RepeatResult(trace=stack_trace(RepeatTrace, rows), final=carry)
