"""Dataset benchmark runner — RobotCar / 4Seasons ATE tables in one command
(``nclt_slam_tpu/cli/benchmark.py``).

The reference publishes per-dataset SLAM headline rows from end-to-end
runner scripts (ORB-SLAM3 stereo 3.91 m ATE RMSE / 72.7 % tracked on 834 m
RobotCar; stereo-inertial 0.93 m on 4Seasons).  This runner closes the
capability row with the port's own estimator on synthetic sessions of the
same shape:

    python -m nclt_slam_tpu_torch.cli.benchmark --dataset robotcar --out runs/rc
    python -m nclt_slam_tpu_torch.cli.benchmark --dataset all --ticks 150 \
        --out runs/bench --device cpu

Per dataset it (1) builds a km-scale urban/suburban loop world, (2) drives
it with the diff-drive dynamics + synthetic IMU, (3) runs the VIO tracker
in the dataset's sensor mode — vision-only for RobotCar stereo (with
condition windows: over-exposure/low-sun feature droughts, the cause of
the reference's 72.7 % tracking), visual-inertial for 4Seasons — (4)
exports the session as a EuRoC mav0 tree + TUM trajectories
(``io/euroc.py``), synthesizing the RobotCar pseudo-IMU from an INS-style
stream (``io/ins_imu.py``), and (5) prints the CHANGELOG-style markdown ATE
table.  The outputs have the JAX package's file set and keys.

A session is one route (a batch of 1) stepped tick by tick on the device:
every tick draws its keys from one 5-way ``split`` and makes the same
calls in the same order as the JAX package's scan body — the chase
controller, ``nav_substeps``, ``imu_block``, ``observe`` (feature survival
scaled by the tick's condition multiplier), ``vio_frame`` (kernel K1 on
every tick) and ``emit_body_pos``.  ``--device`` defaults to the CUDA card
and raises without one (``--device cpu`` for a CPU run).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from nclt_slam_tpu_torch import config as cfg_mod
from nclt_slam_tpu_torch.core import prng
from nclt_slam_tpu_torch.dynamics.diffdrive import (
    init_robot,
    nav_substeps,
    robot_pose3d,
)
from nclt_slam_tpu_torch.eval.metrics import ate_rmse
from nclt_slam_tpu_torch.io.artifacts import save_tum_trajectory
from nclt_slam_tpu_torch.io.euroc import export_euroc
from nclt_slam_tpu_torch.io.ins_imu import synthesize_imu_from_ins
from nclt_slam_tpu_torch.rollout.campaign import campaign_device
from nclt_slam_tpu_torch.scene.terrain import terrain_height
from nclt_slam_tpu_torch.sensors.features import build_scene_features, observe
from nclt_slam_tpu_torch.sensors.imu import imu_block, init_imu
from nclt_slam_tpu_torch.vio.tracker import emit_body_pos, init_vio, vio_frame

# ---------------------------------------------------------------------------
# session worlds
# ---------------------------------------------------------------------------


def _loop_route(length_m: float, rng, spacing: float = 0.35,
                aspect: float = 0.45, wobble: float = 6.0):
    """Closed rounded loop of ~length_m with low-frequency lateral wobble
    (urban blocks are not perfect rectangles).  Returns (M, 2) dense
    centerline points at ``spacing``."""
    per = length_m
    w = per / (2.0 * (1.0 + aspect))
    h = aspect * w
    n = int(per / spacing)
    s = np.linspace(0.0, 1.0, n, endpoint=False)
    # superellipse: smooth corners, no curvature spikes for the chase ctrl
    ang = 2.0 * np.pi * s
    e = 4.0
    x = (w / 2.0) * np.sign(np.cos(ang)) * np.abs(np.cos(ang)) ** (2.0 / e)
    y = (h / 2.0) * np.sign(np.sin(ang)) * np.abs(np.sin(ang)) ** (2.0 / e)
    x = x + wobble * np.sin(3 * ang + rng.uniform(0, 6.28))
    y = y + wobble * np.sin(2 * ang + rng.uniform(0, 6.28))
    return np.stack([x, y], 1).astype(np.float32)


def _facade_world(route_xy: np.ndarray, rng, offset: float = 6.0,
                  every: float = 4.0, radius: float = 1.2,
                  height: float = 8.0):
    """Building facades: cylinder columns along both road sides (the urban
    canyon the RobotCar camera actually sees).  Returns numpy (xy, radius,
    base_z, height)."""
    d = np.diff(route_xy, axis=0, append=route_xy[:1])
    t = d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)
    nrm = np.stack([-t[:, 1], t[:, 0]], 1)
    step = max(int(every / max(np.linalg.norm(d, axis=1).mean(), 1e-9)), 1)
    picks = route_xy[::step]
    nrms = nrm[::step]
    jit = rng.uniform(-0.8, 0.8, (len(picks), 1))
    left = picks + nrms * (offset + jit)
    right = picks - nrms * (offset + jit)
    xy = np.concatenate([left, right]).astype(np.float32)
    rr = np.full(len(xy), radius, np.float32)
    hh = np.full(len(xy), height, np.float32)
    bz = terrain_height(torch.from_numpy(xy[:, 0]),
                        torch.from_numpy(xy[:, 1])).numpy()
    return xy, rr, bz, hh


class _SessTrace(NamedTuple):
    gt_xy: object       # (T, 2)
    gt_yaw: object      # (T,)
    vio_xy: object      # (T, 2)
    lost: object        # (T,) bool
    n_tracked: object   # (T,) int32
    gyro: object        # (T, 3) mean body rate over the tick's substeps
    accel: object       # (T, 3) mean specific force


CHASE_WINDOW = 16
GRAVITY = (0.0, 0.0, -9.81)


def _chase(robot, dxy, chase, n_dense: int):
    """Committed-goal chase controller on the dense loop (2 m lookahead):
    returns (v, w, chase), each (1,)."""
    def norm(d):
        return torch.sqrt((d * d).sum(-1))

    goal = dxy[torch.clamp_max(chase, n_dense - 1).long()]          # (1, 2)
    arrived = norm(goal - robot.xy) < 1.2
    offs = torch.arange(CHASE_WINDOW, device=chase.device)
    idxs = torch.clamp_max(chase[:, None] + 1 + offs, n_dense - 1)  # (1, 16)
    dd = norm(dxy[idxs.long()] - robot.xy[:, None, :])
    far = dd >= 2.0
    # the first far waypoint (argmax of a bool takes the first True)
    nxt = torch.where(far.any(1),
                      chase + 1 + far.to(torch.uint8).argmax(1).to(
                          chase.dtype), chase + 1)
    chase = torch.where(arrived, torch.clamp_max(nxt, n_dense - 1), chase)
    tgt = dxy[chase.long()]
    err = torch.atan2(tgt[:, 1] - robot.xy[:, 1],
                      tgt[:, 0] - robot.xy[:, 0]) - robot.yaw
    err = torch.atan2(torch.sin(err), torch.cos(err))
    full = torch.full_like
    v = torch.where(err.abs() > 0.5, full(err, 0.3),
                    torch.where(err.abs() > 0.15, full(err, 0.55),
                                full(err, 0.85)))
    w = (err * 1.5).clamp(-0.6, 0.6)
    return v, w, chase


def _run_session(route_xy, world, cond_keep, use_imu, cfg, n_ticks,
                 device, chunk=2000, seed=3, progress=None):
    """Drive + track over the loop, one tick at a time on ``device``.
    cond_keep: (n_ticks,) per-tick feature keep multiplier (condition
    windows).  ``chunk`` sets the progress cadence only.  Returns a
    ``_SessTrace`` of numpy arrays with a leading time axis."""
    dev = torch.device(device)
    oxy, orr, obz, ohh = world
    ovalid = np.ones(len(oxy), bool)
    lo = route_xy.min(0) - 20.0
    hi = route_xy.max(0) + 20.0
    fnp = build_scene_features(oxy, orr, obz, ohh, ovalid, cfg.landmarks,
                               bounds=(lo[0], hi[0], lo[1], hi[1]))
    feats = type(fnp)(*(torch.as_tensor(
        a.astype(np.int64) if a.dtype == np.uint32 else a)[None].to(dev)
        for a in fnp))
    grav = torch.tensor(GRAVITY, device=dev)
    dxy = torch.as_tensor(route_xy).to(dev)
    n_dense = len(route_xy)
    oxy_t = torch.as_tensor(oxy)[None].to(dev)
    orr_t = torch.as_tensor(orr)[None].to(dev)
    oval_t = torch.as_tensor(ovalid)[None].to(dev)
    ck = torch.as_tensor(np.asarray(cond_keep, np.float32)).to(dev)
    dt_imu = 1.0 / cfg.sim.physics_hz
    dt_frame = cfg.sim.nav_decimation / cfg.sim.physics_hz

    yaw0 = float(np.arctan2(*(route_xy[1] - route_xy[0])[::-1]))
    k0, key = prng.split(prng.PRNGKey(seed, dev)).unbind(0)
    key = key[None]
    robot = init_robot(
        torch.tensor([[float(route_xy[0, 0]), float(route_xy[0, 1])]],
                     dtype=torch.float32, device=dev),
        torch.tensor([yaw0], dtype=torch.float32, device=dev))
    imu = init_imu(k0[None], cfg.imu)
    vio = init_vio(cfg.landmarks.desc_words, cfg.vio.window_kf, 1, dev)
    chase = torch.ones(1, dtype=torch.int32, device=dev)

    rows, chunks = [], []
    for tick in range(n_ticks):
        key, k_dyn, k_imu, k_obs, k_vio = prng.split(key, 5).unbind(1)
        v, w, chase = _chase(robot, dxy, chase, n_dense)
        robot, (pos_tr, quat_tr) = nav_substeps(
            robot, v, w, oxy_t, orr_t, oval_t, k_dyn, cfg.sim)
        imu, meas = imu_block(imu, pos_tr, quat_tr, dt_imu, k_imu, cfg.imu)
        pos3, _ = robot_pose3d(robot)
        # condition window: scale per-feature survival by the tick multiplier
        f2 = feats._replace(pkeep=feats.pkeep * ck[tick])
        obs = observe(pos3, robot.yaw, f2, oval_t, k_obs, cfg.camera,
                      cfg.landmarks, yaw_rate=w)
        vio, _, _ = vio_frame(vio, obs, meas, dt_frame, grav, cfg.camera,
                              cfg.vio, use_imu, key=k_vio)
        rows.append(_SessTrace(
            gt_xy=robot.xy[0], gt_yaw=robot.yaw[0],
            vio_xy=emit_body_pos(vio)[0, :2], lost=vio.lost[0],
            n_tracked=vio.n_tracked[0], gyro=meas[0, :, 3:].mean(0),
            accel=meas[0, :, :3].mean(0)))
        if len(rows) == chunk or tick == n_ticks - 1:
            chunks.append(_SessTrace(*(torch.stack(f).cpu().numpy()
                                       for f in zip(*rows))))
            rows = []
            if progress:
                progress(tick + 1, n_ticks)
    return _SessTrace(*(np.concatenate(f) for f in zip(*chunks)))


# ---------------------------------------------------------------------------
# conditions
# ---------------------------------------------------------------------------

def _condition_windows(n_ticks, rng, n_windows, frac_lo=0.03, frac_hi=0.08,
                       keep=0.04):
    """Per-tick feature-keep multiplier with ``n_windows`` drought windows
    (low sun / over-exposure segments — what breaks the reference's stereo
    tracking on RobotCar's dusk/night conditions)."""
    ck = np.ones(n_ticks, np.float32)
    for _ in range(n_windows):
        w = int(n_ticks * rng.uniform(frac_lo, frac_hi))
        s = rng.integers(0, max(n_ticks - w, 1))
        ck[s:s + w] = keep
    return ck


# ---------------------------------------------------------------------------
# evaluation + export
# ---------------------------------------------------------------------------

def _evaluate(tr: _SessTrace, settle: int = 100):
    gt = np.asarray(tr.gt_xy)[settle:]
    est = np.asarray(tr.vio_xy)[settle:]
    lost = np.asarray(tr.lost)[settle:]
    tracked = ~lost
    frac = float(tracked.mean())
    seg = np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()
    ate = ate_rmse(est[tracked], gt[tracked], with_scale=True)
    return {"ate_rmse_m": round(float(ate), 3),
            "tracked_pct": round(100.0 * frac, 1),
            "length_m": round(float(seg), 1),
            "frames": int(len(gt))}


def _export(out_dir: Path, name: str, tr: _SessTrace):
    """EuRoC mav0 tree + TUM trajectories for the session (the reference's
    convert_to_euroc.py / TUM-eval interchange)."""
    d = out_dir / name
    d.mkdir(parents=True, exist_ok=True)
    gt = np.asarray(tr.gt_xy)
    yaw = np.asarray(tr.gt_yaw)
    t = np.arange(len(gt)) * 0.1
    z = terrain_height(torch.from_numpy(np.ascontiguousarray(gt[:, 0])),
                       torch.from_numpy(np.ascontiguousarray(gt[:, 1]))
                       ).numpy()
    xyz = np.concatenate([gt, z[:, None]], 1)
    quat = np.stack([np.zeros_like(yaw), np.zeros_like(yaw),
                     np.sin(yaw / 2), np.cos(yaw / 2)], 1)
    export_euroc(d, t, xyz, quat,
                 imu_t_s=t, imu_gyro=np.asarray(tr.gyro),
                 imu_accel=np.asarray(tr.accel))
    est = np.asarray(tr.vio_xy)
    save_tum_trajectory(d / "est_tum.txt", t, np.concatenate(
        [est, np.zeros((len(est), 1))], 1), quat)
    save_tum_trajectory(d / "gt_tum.txt", t, xyz, quat)
    return d


def _robotcar_ins_imu_row(tr: _SessTrace, out_dir: Path):
    """RobotCar pseudo-IMU capability: build an INS-style navigation stream
    from the session and synthesize the IMU the reference derives from the
    Novatel SPAN solution.  Consistency of the synthesized gyro with the
    simulated Phidgets stream closes the loop."""
    gt = np.asarray(tr.gt_xy)
    yaw = np.unwrap(np.asarray(tr.gt_yaw))
    t = np.arange(len(gt)) * 0.1
    vel_en = np.gradient(gt, 0.1, axis=0)
    # NED: north=y(EN->NE swap), down=0 (planar session)
    vel_ned = np.stack([vel_en[:, 1], vel_en[:, 0],
                        np.zeros(len(gt))], 1)
    rpy = np.stack([np.zeros_like(yaw), np.zeros_like(yaw),
                    (np.pi / 2 - yaw)], 1)  # ENU yaw -> NED heading
    t_mid, gyro, accel = synthesize_imu_from_ins(t, vel_ned, rpy)
    np.savetxt(out_dir / "ins_pseudo_imu.csv",
               np.concatenate([t_mid[:, None], gyro, accel], 1),
               delimiter=",", header="t,wx,wy,wz,ax,ay,az")
    # NED body gyro z is -ENU yaw rate; compare magnitudes after settle
    wz_ins = -gyro[:, 2]
    wz_sim = np.asarray(tr.gyro)[:, 2]
    n = min(len(wz_ins), len(wz_sim))
    corr = float(np.corrcoef(wz_ins[100:n], wz_sim[100:n])[0, 1])
    return {"ins_imu_gyro_corr": round(corr, 3)}


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

# 4Seasons' 99.99 % tracked is the JAX package's figure (its
# cli/benchmark.py); the reference's 4Seasons changelog states the ATE
# only.  It is copied here as the JAX package has it, so that the tables of
# the two packages agree.
REFERENCE_ROWS = {
    "robotcar": {"method": "ORB-SLAM3 Stereo", "ate_rmse_m": 3.91,
                 "tracked_pct": 72.7, "length_m": 834.0,
                 "source": "datasets/robotcar/CHANGELOG.md:28-32"},
    "4seasons": {"method": "ORB-SLAM3 Stereo-Inertial", "ate_rmse_m": 0.93,
                 "tracked_pct": 99.99, "length_m": None,
                 "source": "datasets/4seasons/CHANGELOG.md:21"},
}


def dataset_sessions(dataset: str, n_ticks: int, seed: int = 11):
    """The dataset's loop, world, sessions and config, drawn from one
    ``default_rng(seed)`` in the JAX package's order: (route (M, 2), world,
    {session: (cond_keep (n_ticks,), use_imu)}, cfg)."""
    rng = np.random.default_rng(seed)
    if dataset == "robotcar":
        # 834 m urban loop; stereo = vision-only tracking; dusk run carries
        # the drought windows that produce partial tracking
        route = _loop_route(834.0, rng)
        world = _facade_world(route, rng)
        sessions = {
            "overcast": (_condition_windows(n_ticks, rng, 1, keep=0.15),
                         False),
            "dusk": (_condition_windows(n_ticks, rng, 5, frac_lo=0.04,
                                        frac_hi=0.09, keep=0.03), False),
        }
        cfg = cfg_mod.rgbd_no_imu()
    elif dataset == "4seasons":
        # suburban loop, stereo-inertial, benign conditions
        route = _loop_route(700.0, rng, aspect=0.6, wobble=9.0)
        world = _facade_world(route, rng, offset=8.0, every=5.0, radius=0.9)
        sessions = {
            "spring": (np.ones(n_ticks, np.float32), True),
            "autumn": (_condition_windows(n_ticks, rng, 1, frac_lo=0.01,
                                          frac_hi=0.02, keep=0.3), True),
        }
        cfg = cfg_mod.ours()
    else:
        raise SystemExit(f"unknown dataset {dataset}")
    return route, world, sessions, cfg


def run_dataset(dataset: str, out: Path, n_ticks: int, device,
                export: bool, seed: int = 11):
    t_start = time.time()
    route, world, sessions, cfg = dataset_sessions(dataset, n_ticks, seed)

    out.mkdir(parents=True, exist_ok=True)
    rows = {}
    for name, (ck, use_imu) in sessions.items():
        def prog(t, total, _name=name):
            print(f"[benchmark] {dataset}/{_name} {t}/{total} ticks",
                  flush=True)
        tr = _run_session(route, world, ck, use_imu, cfg, n_ticks, device,
                          seed=seed, progress=prog)
        row = _evaluate(tr)
        if export:
            d = _export(out, f"{dataset}_{name}", tr)
            row["euroc_dir"] = str(d / "mav0")
            if dataset == "robotcar":
                row.update(_robotcar_ins_imu_row(tr, d))
        rows[name] = row

    ref = REFERENCE_ROWS[dataset]
    md = [f"## {dataset} benchmark (ours, synthetic session)",
          "",
          "| session | mode | ATE RMSE [m] | tracked % | length [m] |",
          "|---|---|---|---|---|"]
    mode = "VI" if dataset == "4seasons" else "vision-only"
    for name, r in rows.items():
        md.append(f"| {name} | {mode} | {r['ate_rmse_m']} | "
                  f"{r['tracked_pct']} | {r['length_m']} |")
    md.append(f"| _reference_ | {ref['method']} | {ref['ate_rmse_m']} | "
              f"{ref['tracked_pct']} | {ref['length_m'] or 'n/a'} | ")
    md.append("")
    md.append(f"reference row: {ref['source']}")
    table = "\n".join(md)
    print(table)

    payload = {"dataset": dataset, "rows": rows, "reference": ref,
               "n_ticks": n_ticks, "wall_s": round(time.time() - t_start, 1)}
    (out / f"{dataset}_bench.json").write_text(json.dumps(payload, indent=1))
    (out / f"{dataset}_bench.md").write_text(table + "\n")
    print(f"wrote {out}/{dataset}_bench.json")
    return payload


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="robotcar",
                    choices=["robotcar", "4seasons", "all"])
    ap.add_argument("--out", default="runs/dataset_bench")
    ap.add_argument("--ticks", type=int, default=11000)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the CUDA card (default; raises without one) or "
                         "the CPU")
    ap.add_argument("--no-export", action="store_true")
    args = ap.parse_args(argv)

    dev = campaign_device(None if args.device == "cuda" else args.device)
    names = (["robotcar", "4seasons"] if args.dataset == "all"
             else [args.dataset])
    for n in names:
        run_dataset(n, Path(args.out), args.ticks, dev,
                    export=not args.no_export)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
