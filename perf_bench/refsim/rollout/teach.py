"""Teach pass: drive each route and build the teach artefacts
(``nclt_slam_tpu/rollout/teach.py``).

The chase controller reproduces the sim driver's auto-route pure pursuit
(2 m lookahead within the next WPs, arrive at < 1 m, three-tier
speed/steer schedule); the depth mapper accumulates the log-odds teach map;
the landmark recorder snapshots feature observations every 2 m; per-tick GT
poses become the dense pose log the repeat pass subsamples into waypoints.
The route batch is the leading dimension of every tensor, and the tick loop
is a Python loop with the cadence gates as host-side ``if``s.

With ``cfg.teach.run_vio`` (the default) the teach also runs the live VIO
every tick — IMU block, feature observation, ``vio_frame`` — and the drift
monitor at its sample/check cadences; the observation is reused by the
landmark recorder at the sensing cadence.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from refsim.config import Config
from refsim.core import prng
from refsim.dynamics.diffdrive import (
    RobotState,
    init_robot,
    nav_substeps,
    robot_pose3d,
)
from refsim.landmarks.store import LandmarkStore, init_store, record_tick
from refsim.mapping.occupancy import (
    empty_grid,
    integrate_depth,
    occupancy_trinary,
)
from refsim.rollout.scene_pack import PackedRoute, PackedScene
from refsim.sensors.depth import camera_pose, render_depth
from refsim.sensors.features import SceneFeatures, observe
from refsim.sensors.imu import ImuState, imu_block, init_imu
from refsim.vio.drift_monitor import (
    DriftMonitorState,
    check_drift,
    init_drift_monitor,
    push_sample,
)
from refsim.vio.tracker import (
    VioState,
    emit_body_pos,
    init_vio,
    vio_frame,
)

GRAVITY = (0.0, 0.0, -9.81)

CHASE_WINDOW = 16  # WP lookahead window (reference scans next 10)


class TeachCarry(NamedTuple):
    robot: RobotState
    grid: torch.Tensor       # (B, rows, cols) log-odds teach map
    store: LandmarkStore     # landmark recorder state
    chase_idx: torch.Tensor  # (B,) int32 current dense WP
    key: torch.Tensor        # (B, 2)
    done: torch.Tensor       # (B,) bool — route complete
    imu: ImuState            # teach-time VIO state (carried, not stepped)
    vio: VioState
    drift: DriftMonitorState


class TeachTrace(NamedTuple):
    gt_xy: torch.Tensor       # (B, T, 2)
    gt_yaw: torch.Tensor      # (B, T)
    done: torch.Tensor        # (B, T) bool
    cmd_v: torch.Tensor       # (B, T)
    vio_xy: torch.Tensor      # (B, T, 2) zeros without VIO
    vio_tracked: torch.Tensor  # (B, T) -1 without VIO
    drift_max: torch.Tensor   # (B, T)
    aborted: torch.Tensor     # (B, T) bool


class TeachResult(NamedTuple):
    trace: TeachTrace
    teach_grid: torch.Tensor  # (B, rows, cols) trinary int8 map
    store: LandmarkStore      # landmarks.pkl artefact
    n_ticks: torch.Tensor     # (B,) int32 valid tick count
    final: TeachCarry         # carry for chunked continuation


def _scene_features(scene: PackedScene) -> SceneFeatures:
    return SceneFeatures(xyz=scene.feat_xyz, desc=scene.feat_desc,
                         owner=scene.feat_owner, valid=scene.feat_valid,
                         pkeep=scene.feat_pkeep,
                         view_thr=scene.feat_view_thr,
                         view_alpha=scene.feat_view_alpha)


def _norm2(d):
    return torch.sqrt((d * d).sum(-1))


def _chase_cmd(robot: RobotState, route: PackedRoute, chase_idx, cfg: Config):
    """Sim-driver auto-route pure pursuit (2 m lookahead, 3-tier steering):
    drive at WP ``chase_idx`` until within arrive_dist, then jump to the
    first WP in the next window that is >= lookahead away."""
    t = cfg.teach
    rows = torch.arange(chase_idx.shape[0], device=chase_idx.device)
    n_dense = route.n_dense
    goal = route.dense_xy[rows, torch.minimum(chase_idx, n_dense - 1).long()]
    arrived = _norm2(goal - robot.xy) < t.chase_arrive_dist

    offs = torch.arange(CHASE_WINDOW, device=chase_idx.device)[None, :]
    idxs = torch.minimum(chase_idx[:, None] + 1 + offs, n_dense[:, None] - 1)
    d = _norm2(route.dense_xy[rows[:, None], idxs.long()]
               - robot.xy[:, None, :])
    far = d >= t.chase_lookahead
    next_idx = torch.where(far.any(1),
                           chase_idx + 1 + far.to(torch.uint8).argmax(1).int(),
                           chase_idx + 1)
    new_idx = torch.where(arrived, torch.minimum(next_idx, n_dense), chase_idx)
    tgt = route.dense_xy[rows, torch.minimum(new_idx, n_dense - 1).long()]

    err = torch.atan2(tgt[:, 1] - robot.xy[:, 1],
                      tgt[:, 0] - robot.xy[:, 0]) - robot.yaw
    err = torch.atan2(torch.sin(err), torch.cos(err))

    # 3-tier schedule scaled to the effective max speed
    scale = t.max_speed / 0.25
    big = err.abs() > 0.5
    med = (~big) & (err.abs() > 0.15)
    full = torch.full_like
    v = torch.where(big, full(err, 0.10),
                    torch.where(med, full(err, 0.18), full(err, 0.25))) * scale
    w = torch.where(big, (err * 1.8).clamp(-0.5, 0.5),
                    torch.where(med, (err * 1.5).clamp(-0.35, 0.35),
                                (err * 1.2).clamp(-0.2, 0.2)))
    done = (chase_idx >= n_dense - 1) & arrived
    return v, w, new_idx, done


def teach_step(carry: TeachCarry, tick: int, scene: PackedScene,
               route: PackedRoute, cfg: Config):
    """One 10 Hz teach tick for the whole route batch.  Returns
    (new_carry, per-tick trace fields)."""
    key, k_dyn, k_obs, k_imu, k_vio = prng.split(carry.key, 5).unbind(1)

    v, w, chase_idx, done = _chase_cmd(carry.robot, route, carry.chase_idx,
                                       cfg)
    halted = carry.done | carry.drift.aborted
    v = torch.where(halted, torch.zeros_like(v), v)
    w = torch.where(halted, torch.zeros_like(w), w)

    # drops are not present during teach
    valid_teach = scene.valid & ~scene.drop_mask
    robot, (pos_traj, quat_traj) = nav_substeps(
        carry.robot, v, w, scene.xy, scene.radius, valid_teach, k_dyn,
        cfg.sim)
    pos3, _ = robot_pose3d(robot)

    # --- live VIO + drift monitor (vio_drift_monitor gate) ---
    obs = None
    if cfg.teach.run_vio:
        imu, imu_meas = imu_block(carry.imu, pos_traj, quat_traj,
                                  1.0 / cfg.sim.physics_hz, k_imu, cfg.imu)
        obs = observe(pos3, robot.yaw, _scene_features(scene), valid_teach,
                      k_obs, cfg.camera, cfg.landmarks, yaw_rate=w)
        vio, _, _ = vio_frame(
            carry.vio, obs, imu_meas,
            cfg.sim.nav_decimation / cfg.sim.physics_hz,
            torch.tensor(GRAVITY, device=v.device), cfg.camera, cfg.vio,
            True, key=k_vio)
        vio_xy = emit_body_pos(vio)[:, :2]
        drift = carry.drift
        if tick % cfg.teach.drift_sample_period == 0:
            drift = push_sample(drift, vio_xy, robot.xy)
        if tick % cfg.teach.drift_check_period == \
                cfg.teach.drift_check_period - 1:
            drift = check_drift(drift, tick, cfg.teach)
        vio_tracked = vio.n_tracked
    else:
        imu, vio, drift = carry.imu, carry.vio, carry.drift
        vio_xy = torch.zeros_like(robot.xy)
        vio_tracked = torch.full_like(carry.chase_idx, -1)

    # depth mapping + landmark recording at the costmap cadence (2 Hz)
    grid, store = carry.grid, carry.store
    if tick % cfg.map.update_period == 0:
        _, pts, dvalid = render_depth(
            pos3, robot.yaw, scene.xy, scene.radius, scene.base_z,
            scene.height, valid_teach, cfg.camera)
        B = pts.shape[0]
        grid = integrate_depth(grid, robot.xy, pts.reshape(B, -1, 3),
                               dvalid.reshape(B, -1), cfg.map)
        if obs is None:
            obs = observe(pos3, robot.yaw, _scene_features(scene),
                          valid_teach, k_obs, cfg.camera, cfg.landmarks,
                          yaw_rate=w)
        cam_p, _ = camera_pose(pos3, robot.yaw, cfg.camera)
        store = record_tick(store, obs, cam_p, robot.yaw, cfg.camera,
                            cfg.landmarks)

    trace = TeachTrace(gt_xy=robot.xy, gt_yaw=robot.yaw,
                       done=halted | done, cmd_v=v, vio_xy=vio_xy,
                       vio_tracked=vio_tracked,
                       drift_max=drift.drift_max, aborted=drift.aborted)
    return TeachCarry(robot=robot, grid=grid, store=store,
                      chase_idx=chase_idx, key=key, done=carry.done | done,
                      imu=imu, vio=vio, drift=drift), trace


def init_teach_carry(route: PackedRoute, cfg: Config,
                     seed: int = 0) -> TeachCarry:
    """Initial teach state for a batch of packed routes (leading dim B)."""
    B = route.spawn.shape[0]
    dev = route.spawn.device
    robot = init_robot(route.spawn, route.spawn_yaw)
    k_imu, key = prng.split(prng.PRNGKey(seed, dev)).unbind(0)
    return TeachCarry(
        robot=robot,
        grid=empty_grid(cfg.map, B, dev),
        store=init_store(cfg.landmarks, B, dev),
        chase_idx=torch.zeros(B, dtype=torch.int32, device=dev),
        key=key.expand(B, 2).clone(),
        done=torch.zeros(B, dtype=torch.bool, device=dev),
        imu=init_imu(k_imu.expand(B, 2), cfg.imu),
        vio=init_vio(cfg.landmarks.desc_words, cfg.vio.window_kf, B, dev),
        drift=init_drift_monitor(cfg.teach, B, dev),
    )


def stack_trace(cls, rows):
    """Per-tick trace tuples -> one trace with a (B, T, ...) time axis."""
    return cls(*(torch.stack(f, 1) for f in zip(*rows)))


def run_teach(scene: PackedScene, route: PackedRoute, cfg: Config,
              n_ticks: int, seed: int = 0, carry: TeachCarry | None = None,
              tick0: int = 0) -> TeachResult:
    """Roll the teach pass for ``n_ticks``; ``carry``/``tick0`` continue a
    previous chunk."""
    if carry is None:
        carry = init_teach_carry(route, cfg, seed)
    rows = []
    for t in range(tick0, tick0 + n_ticks):
        carry, tr = teach_step(carry, t, scene, route, cfg)
        rows.append(tr)
    trace = stack_trace(TeachTrace, rows)
    return TeachResult(
        trace=trace,
        teach_grid=occupancy_trinary(carry.grid, cfg.map),
        store=carry.store,
        n_ticks=(~trace.done).sum(1).to(torch.int32),
        final=carry,
    )
