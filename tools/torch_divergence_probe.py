#!/usr/bin/env python3
"""Where a campaign route of the port leaves the JAX package's, on the CPU.

Both packages teach one route of the campaign (``config.ours()``, the
calibration tool's teach: the full VI stack, the seed-7 scene and route,
PRNG seed 0) in lock step from the same seed: JAX's ``teach_step`` jitted
once, the port's ``teach_step`` on a batch of one.  With ``--phase
repeat`` each package then takes its waypoints, map and landmark store
from its own teach and both repeat the route in lock step (``--mode``:
ours, or the calibration tool's rgbd and stock baselines; several modes
share the one teach).  For each phase it reports

- the first tick at which each discrete field of the trace differs (the
  VIO match count, the anchor's outcome, the waypoint index, ...) and the
  first at which the GT pose parts by more than the fixture replays'
  bound (``POSE_ATOL``, 1e-3 m, the bound of
  ``tests/test_torch_ours_slice.py``);
- in the repeat, which runs on past the parting (``--after-parting``),
  the first tick from the first discrete difference and the first from
  the parting at which each cadence runs (the matcher, the costmap with
  ``dispatch_plan``, the coarse potential, the local BA): the stages that
  run every fifth or fiftieth tick are checked where they run;
- at each of those ticks, both packages
  stepped once from JAX's carry before the tick (and, in the repeat,
  JAX's teach artefacts), converted into the port: each part of the carry
  and of the trace compared whole, and each stage that runs at that tick
  run by both packages on JAX's inputs to that stage (the teach: the
  chase command, the diff-drive substeps, the IMU block, observe,
  ``vio_frame``; the repeat: the turnaround supervisor, the same sensing
  stages, the local BA, the SLAM pose, the anchor matcher and its relay
  update, the relay tick, the depth render, its points, their
  integration, the costmap window, the coarse potential,
  ``dispatch_plan``, ``dispatch_move`` and the follower, RPP for stock).
  A float part holds within ``STEP_ATOL`` (absolute, and relative to its
  value), an integer or boolean part when equal.  JAX's stages run op by
  op, but for the anchor matcher, which runs compiled as in JAX's
  rollouts (``compiled_match_tick``); the port's matcher holds when it
  holds against that or against JAX's op-by-op run, whose order of
  rounding it follows, or when every RANSAC hypothesis on which the two
  differ is a Horn start tie (``matcher_compare``).

The verdict is "chaos" when every stage holds on JAX's inputs at every
checked tick while the runs part: float32 rounding accumulated over the
ticks, through the closed loop, not a stage.  (The whole step's IMU
state differs even then: the IMU block takes second differences of the
200 Hz substep positions, which turn the substeps' one-ulp rounding into
~1e-3 m/s².)  It is "fault" when a stage differs on JAX's inputs; the
stage names it.  The summary lists every stage checked, so that the
parity check (``tools/torch_campaign_parity.py``) can ask whether the
stages that decide a missed band were among them.

    JAX_PLATFORMS=cpu python tools/torch_divergence_probe.py \\
        --route 04_nw_se [--phase repeat --mode stock rgbd] \\
        [--ticks 3000] [--budget-s 3600] [--out runs/divergence.json] \\
        [--summary artifacts/calibration_torch/divergence.json] \\
        [--dump runs/dump]

``--case-from runs/dump/ROUTE_MODE_tickT.pkl --case-out FILE.npz --route
ROUTE --mode MODE`` writes the matcher's JAX inputs at that dumped tick
(``tests/data/torch_matcher_case.npz`` is ``09_se_ne``'s rgbd tick 150).

``--ticks``, ``--teach-ticks``, ``--after-parting`` and ``--budget-s``
cap the CPU time (about 0.14 s a tick for both packages together on 8
cores, after JAX's ~30 s compile, and a few seconds a checked tick; one
probe at a time: two at once oversubscribe the cores and run twenty
times slower): the probe stops at a cap, the parting found or not.
"""

from __future__ import annotations

import argparse
import functools
import json
import pickle
import sys
import time
from pathlib import Path
from typing import NamedTuple

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from nclt_slam_tpu import config as jcfg  # noqa: E402
from nclt_slam_tpu.rollout import campaign as jcamp  # noqa: E402
from nclt_slam_tpu.rollout import teach as jteach  # noqa: E402
from nclt_slam_tpu_torch import config as tcfg  # noqa: E402
from nclt_slam_tpu_torch import interop  # noqa: E402
from nclt_slam_tpu_torch.rollout import campaign as tcamp  # noqa: E402
from nclt_slam_tpu_torch.rollout import teach as tteach  # noqa: E402

POSE_ATOL = 1e-3     # tests/test_torch_ours_slice.py
STEP_ATOL = 1e-4     # one step from one carry: float parts, absolute and
#                      relative to the value
TEACH_DISCRETE = ("done", "vio_tracked", "aborted")
REPEAT_DISCRETE = ("regime", "anchor_ok", "anchor_reason", "anchor_inliers",
                   "vio_tracked", "wp_idx", "done", "fired")


def batch1(tree):
    return interop.from_numpy_tree(jax.tree_util.tree_map(
        lambda x: np.asarray(x)[None], tree), "cpu")


@functools.lru_cache(maxsize=None)
def compiled_match_tick(cam, cfg):
    """JAX's ``match_tick`` compiled, as the JAX package's rollout runs it:
    the matcher result the probe carries on.  Its Horn power iteration is
    ill-conditioned, so op by op (eagerly) JAX rounds otherwise than its
    own compiled code (0.5 mm and 2.7e-3 px apart at ``09_se_ne``, rgbd,
    tick 150), more than ``STEP_ATOL`` (``matcher_compare``).  The probe's
    other stages run eagerly; none of them has shown that."""
    from nclt_slam_tpu.landmarks import matcher as jmat

    return jax.jit(lambda store, obs, xy, yaw, query, key, extra:
                   jmat.match_tick(store, obs, xy, yaw, query, key, cam, cfg,
                                   consistency_extra_m=extra))


def jmat_eager(cj):
    """JAX's ``match_tick`` run op by op (``cj``'s camera and landmarks):
    every product of its 4 x 4 algebra rounded once, in the order of its
    unrolled sums, as the port computes them."""
    from nclt_slam_tpu.landmarks import matcher as jmat

    def run(store, obs, xy, yaw, query, key, extra):
        return jmat.match_tick(store, obs, xy, yaw, query, key, cj.camera,
                               cj.landmarks, consistency_extra_m=extra)
    return run


def matcher_compare(port, compiled, eager, ties=None) -> dict:
    """The port's matcher against JAX's compiled matcher (``compare``) or,
    where that does not hold, against the same JAX code run op by op: the
    compiled code fuses multiply-adds, so on an ill-conditioned power
    iteration the two JAX runs part by more than ``STEP_ATOL`` while the
    port follows the op-by-op order (0.5 mm and 2.7e-3 px at
    ``09_se_ne``, rgbd, tick 150).  Where neither holds, ``ties()``
    (``matcher_start_ties``) may show that every RANSAC hypothesis on
    which the two packages differ is a Horn start tie, which float32 cannot
    decide: the stage then holds.  Each part records what it was held to
    (``reference``: compiled, eager, start_tie) and the tie record, if
    any."""
    parts = compare(port, compiled)
    ref, extra = "compiled", {}
    if not held(parts):
        alt = compare(port, eager)
        if held(alt):
            parts, ref = alt, "eager"
        elif ties is not None:
            extra = {"start_ties": ties()}
            t = extra["start_ties"]
            if t["differing"] and not t["not_ties"]:
                parts = {k: dict(v, held=True) for k, v in parts.items()}
                ref = "start_tie"
    return {k: dict(v, reference=ref, **extra) for k, v in parts.items()}


# a Horn start ties the best when its float64 Rayleigh quotient is within
# this of the best's (relative): float32's rounding of a 16-term sum
START_TIE_REL = 2.0 ** -20


def matcher_start_ties(args, cj) -> dict:
    """On ``match_tick``'s candidates at JAX's inputs ``args`` (JAX's
    distance and heading gates, block-death masks and keys), RANSAC's
    3-point hypotheses solved by JAX's ``_kabsch`` (op by op) and by the
    port's; every valid hypothesis whose rotation (beyond 1e-5) or inlier
    count differs is a Horn start tie when JAX's and the port's rotations
    are two different starts' float64 results (within 1e-6) whose Rayleigh
    quotients lie within ``START_TIE_REL`` of each other.  Returns
    {"differing": n, "ties": n, "not_ties": [[candidate, hypothesis],
    ...]}."""
    from nclt_slam_tpu.landmarks.matcher import _block_dead as j_block_dead
    from nclt_slam_tpu.landmarks.matcher import _kabsch as j_kabsch
    from nclt_slam_tpu.landmarks.matcher import _project as j_project
    from nclt_slam_tpu.sensors.features import cross_check_match as j_match
    from nclt_slam_tpu_torch.landmarks import matcher as tm

    store, obs, xy, yaw = args[:4]
    key, lc = args[5], cj.landmarks
    d = jnp.linalg.norm(store.cam_pos[:, :2] - xy[None, :], axis=-1)
    hdg = jnp.abs(jnp.arctan2(jnp.sin(store.cam_yaw - yaw),
                              jnp.cos(store.cam_yaw - yaw)))
    cand = (jnp.arange(lc.max_landmarks) < store.count) & \
        (d < lc.candidate_radius_m) & (hdg < jnp.deg2rad(lc.heading_tol_deg))
    d_masked = jnp.where(cand, d, jnp.inf)
    top = np.asarray(jnp.argsort(d_masked))[:lc.max_candidates]
    top_ok = np.isfinite(np.asarray(d_masked)[top])
    sess_off = jnp.mod(store.cam_pos[0, 0] * 0.7548777
                       + store.cam_pos[0, 1] * 0.5698403, 1.0)
    keys = jax.random.split(key, lc.max_candidates)
    out = {"differing": 0, "ties": 0, "not_ties": []}
    for ci, li in enumerate(top):
        if not top_ok[ci]:
            continue
        m_idx, matched = j_match(store.desc[li], store.feat_valid[li],
                                 obs.desc, obs.valid)
        matched = np.asarray(matched & ~j_block_dead(li, sess_off, lc))
        pool = np.asarray(jnp.argsort(~jnp.asarray(matched)))
        j = np.asarray(jax.random.randint(keys[ci], (lc.ransac_iterations, 3),
                                          0, max(int(matched.sum()), 1)))
        teach = np.asarray(store.p3d_cam[li])
        P = teach[pool[j]]
        Q = np.asarray(obs.p3d_cam)[np.asarray(m_idx)][pool[j]]
        ok = (j[:, 0] != j[:, 1]) & (j[:, 1] != j[:, 2]) & \
            (j[:, 0] != j[:, 2]) & (matched.sum() >= 3)
        Rj, tj = (np.asarray(x) for x in j_kabsch(
            jnp.asarray(P), jnp.asarray(Q), jnp.ones(P.shape[:2])))
        Rt, tt = (x.numpy() for x in tm._kabsch(
            torch.from_numpy(P), torch.from_numpy(Q),
            torch.ones(P.shape[:2])))
        V, ray, mp, mq = tm._horn_starts(
            torch.from_numpy(P).double(), torch.from_numpy(Q).double(),
            torch.ones(P.shape[:2], dtype=torch.float64))
        starts = [tm._start_pose(V, torch.full((P.shape[0],), k), mp, mq)[0]
                  .numpy() for k in range(4)]
        uv_live = np.asarray(obs.uv)[np.asarray(m_idx)]

        def inliers(R, t):
            pred = np.einsum("hij,fj->hfi", R, teach) + t[:, None]
            uv = np.asarray(j_project(jnp.asarray(pred), cj.camera))
            err = np.linalg.norm(uv - uv_live, axis=-1)
            return ((err < lc.ransac_reproj_px) & matched).sum(-1)

        apart = np.abs(Rj - Rt).max((-2, -1)) > 1e-5
        differ = np.flatnonzero(ok & (apart | (inliers(Rj, tj)
                                               != inliers(Rt, tt))))
        for h in differ:
            near = [np.abs(starts[k][h] - R[h]).max((-2, -1))
                    for R in (Rj, Rt) for k in range(4)]
            kj = int(np.argmin(near[:4]))
            kt = int(np.argmin(near[4:]))
            r = ray[h].numpy()
            tie = kj != kt and near[kj] < 1e-6 and near[4 + kt] < 1e-6 and \
                abs(r[kj] - r[kt]) < START_TIE_REL * abs(r[kj])
            out["differing"] += 1
            if tie:
                out["ties"] += 1
            else:
                out["not_ties"].append([ci, int(h)])
    return out


def row0(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x)[0],
                                  interop.to_numpy_tree(tree))


def leaf_diff(a, b) -> tuple[float, float, bool]:
    """(largest |a - b|, largest |b| there, discrete parts equal)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind not in "fc":
        return 0.0, 0.0, bool(np.array_equal(a, b))
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    same = (a64 == b64) | (np.isnan(a64) & np.isnan(b64))
    d = np.where(same, 0.0, np.abs(a64 - b64))
    d = np.nan_to_num(d, nan=np.inf)
    if d.size == 0 or d.max() == 0.0:
        return 0.0, 0.0, True
    i = np.unravel_index(np.argmax(d), d.shape)
    return float(d[i]), float(np.abs(b64[i])), True


def compare(port, ref, fields=None) -> dict:
    """Largest difference of each part of two trees of one route (port:
    numpy of the batch's row 0; ref: JAX), held when every float leaf is
    within ``STEP_ATOL`` (absolute, and relative to the leaf's value) and
    every integer or boolean leaf equal."""
    out = {}
    for name in fields or ref._fields:
        p = jax.tree_util.tree_leaves(getattr(port, name))
        r = jax.tree_util.tree_leaves(getattr(ref, name))
        worst, at, exact = 0.0, 0.0, True
        for a, b in zip(p, r):
            d, m, eq = leaf_diff(a, b)
            exact &= eq
            if d > worst:
                worst, at = d, m
        out[name] = {"max_abs": worst, "value_there": at,
                     "discrete_equal": exact,
                     "held": worst <= STEP_ATOL * (1.0 + at) and exact}
    return out


def held(parts: dict) -> bool:
    return all(v["held"] for v in parts.values())


def verdict_of(out: dict) -> tuple[bool, list]:
    ok = {k: (v["held"] if "held" in v else held(v)) for k, v in out.items()}
    return all(ok.values()), [k for k, v in ok.items() if not v]


def sensing_stages(out, ctx, robot_j, v, w, imu_j, vio_j, keys, valid_j,
                   valid_t, occluders: bool, use_slam: bool = True,
                   use_imu: bool = True):
    """The stages both ticks share, each run by both packages on JAX's
    inputs: the diff-drive substeps, the IMU block, observe and
    ``vio_frame``.  ``keys``: JAX's (k_dyn, k_obs, k_imu, k_vio).  Returns
    JAX's outputs, the inputs of the stages after them."""
    from nclt_slam_tpu.dynamics import diffdrive as jdd
    from nclt_slam_tpu.sensors import features as jfeat
    from nclt_slam_tpu.sensors import imu as jimu
    from nclt_slam_tpu.vio import tracker as jvio
    from nclt_slam_tpu_torch.dynamics import diffdrive as tdd
    from nclt_slam_tpu_torch.sensors import features as tfeat
    from nclt_slam_tpu_torch.sensors import imu as timu
    from nclt_slam_tpu_torch.vio import tracker as tvio

    cj, ct = ctx["cfg_j"], ctx["cfg_t"]
    sj, st = ctx["scene_j"], ctx["scene_t"]
    k_dyn, k_obs, k_imu, k_vio = keys
    b1 = batch1
    robot, (pos, quat) = jdd.nav_substeps(robot_j, v, w, sj.xy, sj.radius,
                                          valid_j, k_dyn, cj.sim)
    trobot, (tpos, tquat) = tdd.nav_substeps(
        b1(robot_j), b1(v), b1(w), st.xy, st.radius, valid_t, b1(k_dyn),
        ct.sim)
    out["substeps"] = compare(
        SubstepOut(row0(trobot), tpos[0].numpy(), tquat[0].numpy()),
        SubstepOut(robot, pos, quat))
    pos3, _ = jdd.robot_pose3d(robot)

    dt = 1.0 / cj.sim.physics_hz
    imu, meas = jimu.imu_block(imu_j, pos, quat, dt, k_imu, cj.imu)
    timu_s, tmeas = timu.imu_block(b1(imu_j), b1(pos), b1(quat), dt,
                                   b1(k_imu), ct.imu)
    out["imu_block"] = compare(ImuOut(row0(timu_s), tmeas[0].numpy()),
                               ImuOut(imu, meas))

    kw_j, kw_t = {}, {}
    if occluders:
        kw_j = dict(occluders=(sj.xy, sj.radius, sj.base_z, sj.height,
                               valid_j & sj.drop_mask,
                               jnp.arange(sj.xy.shape[0], dtype=jnp.int32)),
                    px_session_amp=cj.camera.px_bias_session_amp)
        kw_t = dict(occluders=(st.xy, st.radius, st.base_z, st.height,
                               valid_t & st.drop_mask,
                               torch.arange(st.xy.shape[1],
                                            dtype=torch.int32)),
                    px_session_amp=ct.camera.px_bias_session_amp)
    obs = jfeat.observe(pos3, robot.yaw, jteach._scene_features(sj),
                        valid_j, k_obs, cj.camera, cj.landmarks,
                        yaw_rate=w, **kw_j)
    tobs = tfeat.observe(b1(pos3), b1(robot.yaw),
                         tteach._scene_features(st), valid_t, b1(k_obs),
                         ct.camera, ct.landmarks, yaw_rate=b1(w), **kw_t)
    out["observe"] = compare(row0(tobs), obs)
    jax_out = {"robot": robot, "pos3": pos3, "imu": imu, "meas": meas,
               "obs": obs, "vio": vio_j, "slam_ok": jnp.array(False)}
    if not use_slam:
        return jax_out
    dtf = cj.sim.nav_decimation / cj.sim.physics_hz
    vio, slam_ok, _ = jvio.vio_frame(vio_j, obs, meas, dtf, jteach.GRAVITY,
                                     cj.camera, cj.vio, use_imu, key=k_vio)
    tv_s, tslam_ok, _ = tvio.vio_frame(
        b1(vio_j), b1(obs), b1(meas), dtf, torch.tensor(tteach.GRAVITY),
        ct.camera, ct.vio, use_imu, key=b1(k_vio))
    out["vio_frame"] = compare(VioOut(row0(tv_s), tslam_ok[0].numpy()),
                               VioOut(vio, slam_ok))
    jax_out.update(vio=vio, slam_ok=slam_ok)
    return jax_out


def keys_stage(out, key_j, n):
    from nclt_slam_tpu_torch.core import prng

    keys_j = jax.random.split(key_j, n)
    keys_t = prng.split(batch1(key_j), n)
    eq = bool(np.array_equal(keys_t[0].numpy(), np.asarray(keys_j)))
    out["keys"] = {"discrete_equal": eq, "max_abs": 0.0, "held": eq}
    return keys_j


def stage_chain(jc, tick, ctx) -> dict:
    """The teach tick's stages, each run by both packages on JAX's inputs
    to that stage (JAX's carry and JAX's outputs of the stages before):
    the chase command, then ``sensing_stages``."""
    cj, ct = ctx["cfg_j"], ctx["cfg_t"]
    sj, rj, st, rt = ctx["scene_j"], ctx["route_j"], ctx["scene_t"], \
        ctx["route_t"]
    out = {}
    _, k_dyn, k_obs, k_imu, k_vio = keys_stage(out, jc.key, 5)
    v, w, chase, done = jteach._chase_cmd(jc.robot, rj, jc.chase_idx, cj)
    tv, tw, tchase, tdone = tteach._chase_cmd(batch1(jc.robot), rt,
                                              batch1(jc.chase_idx), ct)
    out["chase_cmd"] = compare(
        ChaseOut(tv[0].numpy(), tw[0].numpy(), tchase[0].numpy(),
                 tdone[0].numpy()), ChaseOut(v, w, chase, done))
    halted = jc.done | jc.drift.aborted
    v = jnp.where(halted, 0.0, v)
    w = jnp.where(halted, 0.0, w)
    sensing_stages(out, ctx, jc.robot, v, w, jc.imu, jc.vio,
                   (k_dyn, k_obs, k_imu, k_vio),
                   sj.valid & ~sj.drop_mask, st.valid & ~st.drop_mask,
                   occluders=False)
    ok, differs = verdict_of(out)
    return {"tick": tick, "stages": out, "held": ok, "differs": differs,
            "checked": sorted(out)}


def repeat_stage_chain(jc, tick, ctx) -> dict:
    """Every stage of the repeat tick that runs at ``tick``, each run by
    both packages on JAX's inputs to that stage: the turnaround
    supervisor, ``sensing_stages`` (observe with the dropped obstacles as
    occluders, as the repeat runs it), the local BA (its cadence), the
    SLAM pose, the anchor matcher and its relay update (the matcher's
    cadence), the relay tick, the costmap (render, points, integrate, the
    window; the costmap's cadence), the coarse potential (the replan
    cadence), ``dispatch_plan`` (the costmap's cadence), ``dispatch_move``
    and the follower (RPP for stock).  The watchdog and the bring-up hold
    are a few lines of the tick itself; the whole step holds them."""
    from nclt_slam_tpu.control import pure_pursuit as jpp
    from nclt_slam_tpu.control import rpp as jrpp
    from nclt_slam_tpu.control import supervisor as jsup
    from nclt_slam_tpu.fusion import relay as jrel
    from nclt_slam_tpu.mapping import occupancy as jocc
    from nclt_slam_tpu.planning import dispatcher as jdis
    from nclt_slam_tpu.planning import wavefront as jwf
    from nclt_slam_tpu.scene.terrain import terrain_height as jterrain
    from nclt_slam_tpu.sensors import depth as jdep
    from nclt_slam_tpu.vio import tracker as jvio
    from nclt_slam_tpu_torch.control import pure_pursuit as tpp
    from nclt_slam_tpu_torch.control import rpp as trpp
    from nclt_slam_tpu_torch.control import supervisor as tsup
    from nclt_slam_tpu_torch.fusion import relay as trel
    from nclt_slam_tpu_torch.landmarks import matcher as tmat
    from nclt_slam_tpu_torch.mapping import occupancy as tocc
    from nclt_slam_tpu_torch.planning import dispatcher as tdis
    from nclt_slam_tpu_torch.planning import wavefront as twf
    from nclt_slam_tpu_torch.scene.terrain import terrain_height as tterrain
    from nclt_slam_tpu_torch.sensors import depth as tdep
    from nclt_slam_tpu_torch.vio import tracker as tvio

    cj, ct = ctx["cfg_j"], ctx["cfg_t"]
    sj, rj, st, rt = ctx["scene_j"], ctx["route_j"], ctx["scene_t"], \
        ctx["route_t"]
    b1 = batch1
    out = {}
    _, k_dyn, k_obs, k_match, k_fuse, k_vio = keys_stage(out, jc.key, 6)
    sup = jsup.supervisor_tick(jc.sup, jc.robot.xy, rj.turnaround,
                               cj.supervisor)
    tsup_s = tsup.supervisor_tick(b1(jc.sup), b1(jc.robot.xy),
                                  rt.turnaround, ct.supervisor)
    out["supervisor"] = compare(row0(tsup_s), sup)
    valid_j = sj.valid & ~(sj.drop_mask & sup.fired)
    valid_t = st.valid & ~(st.drop_mask & bool(sup.fired))
    mode = cj.mode
    s = sensing_stages(out, ctx, jc.robot, jc.cmd[0], jc.cmd[1], jc.imu,
                       jc.vio, (k_dyn, k_obs, k_fuse, k_vio), valid_j,
                       valid_t, occluders=True, use_slam=mode.use_slam,
                       use_imu=mode.use_imu)
    robot, pos3, obs = s["robot"], s["pos3"], s["obs"]
    gt_yaw = robot.yaw

    # localization after the VIO
    vio, slam_ok = s["vio"], s["slam_ok"]
    if mode.use_slam:
        if cj.vio.enable_local_ba and tick % 10 == 3:
            ba = jvio.local_ba(vio, cj.camera, cj.vio)
            out["local_ba"] = compare(
                row0(tvio.local_ba(b1(vio), ct.camera, ct.vio)), ba)
            vio = ba
        slam_t, slam_q = jvio.emit_slam_pose(vio, cj.camera)
        tt, tq = tvio.emit_slam_pose(b1(vio), ct.camera)
        out["emit_slam_pose"] = compare(
            PoseOut(tt[0].numpy(), tq[0].numpy()), PoseOut(slam_t, slam_q))
        slam_ok = slam_ok & jnp.isfinite(slam_t).all() & \
            jnp.isfinite(slam_q).all()
    else:
        slam_t, slam_q = jnp.zeros(3), jnp.array([0.0, 0.0, 0.0, 1.0])
    fusion = jc.fusion
    if mode.use_anchors and tick % cj.landmarks.tick_period == 0:
        drought_s = jnp.maximum(tick - fusion.anchor_tick, 0).astype(
            jnp.float32) * 0.1
        extra = jnp.minimum(cj.landmarks.consistency_relax_per_s * drought_s,
                            cj.landmarks.consistency_relax_max_m)
        query = jnp.array([robot.xy[0], robot.xy[1], 0.0])
        args = (ctx["store_j"], obs, robot.xy, gt_yaw, query, k_match, extra)
        ctx["matcher_inputs"] = args
        res = compiled_match_tick(cj.camera, cj.landmarks)(*args)
        tres = tmat.match_tick(ctx["store_jt"], b1(obs), b1(robot.xy),
                               b1(gt_yaw), b1(query), b1(k_match), ct.camera,
                               ct.landmarks, consistency_extra_m=b1(extra))
        out["match_tick"] = matcher_compare(
            row0(tres), res, jmat_eager(cj)(*args),
            lambda: matcher_start_ties(args, cj))
        upd = jrel.anchor_update(fusion, res.xy, res.std, tick, cj.fusion)
        tupd = trel.anchor_update(b1(fusion), b1(res.xy), b1(res.std), tick,
                                  ct.fusion)
        out["anchor_update"] = compare(row0(tupd), upd)
        fusion = jax.tree_util.tree_map(
            lambda new, old: jnp.where(res.ok, new, old), upd, fusion)
    fused = jrel.fusion_tick(fusion, robot.xy[0], robot.xy[1], gt_yaw,
                             slam_t, slam_q, slam_ok, jnp.int32(tick),
                             k_fuse, cj.encoder, cj.fusion)
    tfused = trel.fusion_tick(b1(fusion), b1(robot.xy[0]), b1(robot.xy[1]),
                              b1(gt_yaw), b1(slam_t), b1(slam_q),
                              b1(slam_ok), tick, b1(k_fuse), ct.encoder,
                              ct.fusion)
    out["fusion_tick"] = compare(
        FusionOut(row0(tfused[0]), *(x[0].numpy() for x in tfused[1:])),
        FusionOut(*fused))
    fusion, nav_x, nav_y, nav_yaw, _ = fused
    nav_xy = jnp.stack([nav_x, nav_y])

    # costmap at its cadence: the camera senses the true pose, the points
    # are placed through the nav pose
    grid_live, cost_win = jc.grid_live, jc.cost_win
    win_r0, win_c0 = jc.win_r0, jc.win_c0
    teach_j, teach_t = ctx["grid_j"], ctx["grid_jt"]
    update = tick % cj.map.update_period == 0
    if update:
        depth = jdep.render_depth(pos3, robot.yaw, sj.xy, sj.radius,
                                  sj.base_z, sj.height, valid_j, cj.camera)
        tdepth = tdep.render_depth(b1(pos3), b1(robot.yaw), st.xy,
                                   st.radius, st.base_z, st.height, valid_t,
                                   ct.camera)
        out["render_depth"] = compare(
            DepthOut(*(x[0].numpy() for x in tdepth)), DepthOut(*depth))
        depth, _, dvalid = depth
        nav_pos3 = jnp.array([nav_xy[0], nav_xy[1],
                              jterrain(nav_xy[0], nav_xy[1]) + 0.13])
        pts = jdep.cam_points_to_world(
            jdep.depth_to_cam_points(depth, cj.camera), nav_pos3, nav_yaw,
            cj.camera)
        tnav3 = torch.cat([b1(nav_xy), (tterrain(b1(nav_x), b1(nav_y))
                                        + 0.13)[:, None]], -1)
        tpts = tdep.cam_points_to_world(
            tdep.depth_to_cam_points(b1(depth), ct.camera), tnav3,
            b1(nav_yaw), ct.camera)
        out["depth_points"] = compare(Arr(tpts[0].numpy()), Arr(pts))
        grid_live = jocc.integrate_depth(jc.grid_live, nav_xy,
                                         pts.reshape(-1, 3),
                                         dvalid.reshape(-1), cj.map)
        tgrid = tocc.integrate_depth(b1(jc.grid_live), b1(nav_xy),
                                     b1(pts.reshape(-1, 3)),
                                     b1(dvalid.reshape(-1)), ct.map)
        out["integrate_depth"] = compare(Arr(tgrid[0].numpy()),
                                         Arr(grid_live))
        combined = jnp.maximum(jocc.occupancy_trinary(grid_live, cj.map),
                               teach_j)
        r, c = jocc.world_to_cell(nav_xy[0], nav_xy[1], cj.map)
        occ_win, win_r0, win_c0 = jocc.crop_window(combined, r, c,
                                                   cj.planner.window)
        cost_win = jocc.inflate_cost(occ_win, cj.map)
        # the port crops first, as its repeat_step does
        tr, tc_ = tocc.world_to_cell(b1(nav_x), b1(nav_y), ct.map)
        live_win, tr0, tc0 = tocc.crop_window(b1(grid_live), tr, tc_,
                                              ct.planner.window)
        twin, _, _ = tocc.crop_window(teach_t, tr, tc_, ct.planner.window)
        tcost = tocc.inflate_cost(torch.maximum(
            tocc.occupancy_trinary(live_win, ct.map), twin), ct.map)
        out["costmap_window"] = compare(
            WindowOut(tcost[0].numpy(), tr0[0].numpy(), tc0[0].numpy()),
            WindowOut(cost_win, win_r0, win_c0))

    coarse_phi, coarse_goal = jc.coarse_phi, jc.coarse_goal
    if cj.planner.coarse_seed and tick % cj.planner.replan_period == 1:
        coarse_phi = jwf.coarse_potential(
            jwf.coarse_traversal(teach_j, cj.map, cj.planner),
            jc.dispatch.target, cj.map, cj.planner)
        tphi = twf.coarse_potential(
            twf.coarse_traversal(teach_t, ct.map, ct.planner),
            b1(jc.dispatch.target), ct.map, ct.planner)
        out["coarse_potential"] = compare(Arr(tphi[0].numpy()),
                                          Arr(coarse_phi))
        coarse_goal = jc.dispatch.target
    drop_j = sj.drop_mask & valid_j
    drop_t = st.drop_mask & valid_t
    dispatch = jc.dispatch
    if update:
        seed = cj.planner.coarse_seed
        dispatch = jdis.dispatch_plan(
            dispatch, nav_xy, cost_win, win_r0, win_c0, sj.xy, sj.radius,
            drop_j, cj.map, cj.planner, jnp.int32(tick),
            coarse_phi=coarse_phi if seed else None, coarse_goal=coarse_goal)
        tdisp = tdis.dispatch_plan(
            b1(jc.dispatch), b1(nav_xy), b1(cost_win), b1(win_r0),
            b1(win_c0), st.xy, st.radius, drop_t, ct.map, ct.planner, tick,
            coarse_phi=b1(coarse_phi) if seed else None,
            coarse_goal=b1(coarse_goal))
        out["dispatch_plan"] = compare(row0(tdisp), dispatch)
    moved = jdis.dispatch_move(dispatch, nav_xy, sj.xy, sj.radius, drop_j,
                               cj.planner)
    tmoved = tdis.dispatch_move(b1(dispatch), b1(nav_xy), st.xy, st.radius,
                                drop_t, ct.planner)
    out["dispatch_move"] = compare(row0(tmoved), moved)

    # the follower on JAX's dispatcher after the GT-stall watchdog: the
    # one JAX's whole step carries out of the tick
    d = ctx["jstep"](jc, tick)[0].dispatch
    active = d.has_path & ~d.done
    t_now = jnp.float32(tick) * 0.1
    tt_now = torch.full((), tick, dtype=torch.float32) * 0.1
    if cj.control.use_rpp:
        fol = jrpp.rpp_tick(jc.ctrl, nav_xy, nav_yaw, d.path_xy, d.n_path,
                            active, t_now, cj.rpp)
        tfol = trpp.rpp_tick(b1(jc.ctrl), b1(nav_xy), b1(nav_yaw),
                             b1(d.path_xy), b1(d.n_path), b1(active), tt_now,
                             ct.rpp)
    else:
        fol = jpp.follower_tick(
            jc.ctrl, nav_xy, nav_yaw, d.path_xy, d.n_path, active,
            d.plan_version, cost_win, win_r0, win_c0, t_now, cj.map,
            cj.control, cj.planner.window)
        tfol = tpp.follower_tick(
            b1(jc.ctrl), b1(nav_xy), b1(nav_yaw), b1(d.path_xy),
            b1(d.n_path), b1(active), b1(d.plan_version), b1(cost_win),
            b1(win_r0), b1(win_c0), tt_now, ct.map, ct.control,
            ct.planner.window)
    out["follower"] = compare(
        FollowOut(row0(tfol[0]), tfol[1][0].numpy(), tfol[2][0].numpy()),
        FollowOut(*fol))
    ok, differs = verdict_of(out)
    return {"tick": tick, "stages": out, "held": ok, "differs": differs,
            "checked": sorted(out)}


class ChaseOut(NamedTuple):
    v: object
    w: object
    chase_idx: object
    done: object


class SubstepOut(NamedTuple):
    robot: object
    pos_traj: object
    quat_traj: object


class ImuOut(NamedTuple):
    state: object
    meas: object


class VioOut(NamedTuple):
    state: object
    slam_ok: object


class PoseOut(NamedTuple):
    t: object
    q: object


class FusionOut(NamedTuple):
    state: object
    nav_x: object
    nav_y: object
    nav_yaw: object
    regime: object


class DepthOut(NamedTuple):
    depth: object
    points: object
    valid: object


class WindowOut(NamedTuple):
    cost_win: object
    r0: object
    c0: object


class FollowOut(NamedTuple):
    state: object
    v: object
    w: object


class Arr(NamedTuple):
    value: object


def one_step(jstep, tstep, jcarry, tick, ctx, chain) -> dict:
    """Both packages step ``jcarry`` once at ``tick``, whole and stage by
    stage (``chain``)."""
    jc, jtr = jstep(jcarry, tick)
    tc, ttr = tstep(batch1(jcarry), tick)
    carry = compare(row0(tc), jc)
    trace = compare(row0(ttr), jtr)
    return {"tick": tick, "carry": carry, "trace": trace,
            "carry_held": held(carry) and held(trace),
            "carry_differs": sorted(
                [k for k, v in carry.items() if not v["held"]]
                + [f"trace.{k}" for k, v in trace.items() if not v["held"]]),
            "stages": chain(jcarry, tick, ctx)}


def lockstep(jstep, tstep, jc, tc, ticks, discrete, ctx, chain, t_start,
             budget_s, stop_at_parting=True, until_done=False,
             tstep_check=None, cadences=(), after_parting=None,
             check_ticks=()):
    """Step both packages from their own carries and check one step from
    JAX's carry before each tick of interest (the port stepped by
    ``tstep_check``, default ``tstep``): the first tick at which each
    discrete field of the trace differs, the first GT parting, and, for
    each ``(name, predicate)`` of ``cadences``, the first tick at or after
    the first discrete difference and the first at or after the parting
    at which that cadence runs (a stage that runs every fifth tick is
    checked where it runs).  With
    ``after_parting`` the lock step runs on past the parting until every
    such tick is checked or that many ticks have passed.  The ticks of
    ``check_ticks`` are checked too, and the lock step runs until the last
    of them.  Returns (record, jc, tc, traces_j, traces_t)."""
    tstep_check = tstep_check or tstep
    rec = {"first_discrete": None, "parting": None, "first_differs": {},
           "checks": [], "gt_gap_m_every_100": []}
    tj, tt = [], []
    anchors = {}    # "first discrete difference" / "parting" -> tick
    cad_done = set()
    t = -1
    for t in range(ticks):
        prev = jc
        jc, jtr = jstep(jc, t)
        tc, ttr = tstep(tc, t)
        tj.append(jtr)
        tt.append(ttr)
        d = float(np.hypot(*(ttr.gt_xy[0].numpy() - np.asarray(jtr.gt_xy))))
        if t % 100 == 0:
            rec["gt_gap_m_every_100"].append(d)
            print(f"[probe] {chain.__name__} tick {t}: GT gap {d:.2e} m, "
                  f"{time.perf_counter() - t_start:.0f} s", flush=True)
        why = []
        bad = [f for f in discrete if f not in rec["first_differs"]
               and not np.array_equal(getattr(ttr, f)[0].numpy(),
                                      np.asarray(getattr(jtr, f)))]
        for f in bad:
            rec["first_differs"][f] = t
            why.append(f"first {f} difference")
        if bad and rec["first_discrete"] is None:
            anchors["first discrete difference"] = t
            rec["first_discrete"] = {
                "tick": t, "fields": bad, "gt_gap_m": d,
                "port": {f: getattr(ttr, f)[0].tolist() for f in bad},
                "jax": {f: np.asarray(getattr(jtr, f)).tolist()
                        for f in bad}}
            print(f"[probe] first discrete difference at tick {t}: "
                  f"{bad}", flush=True)
        if rec["parting"] is None and d > POSE_ATOL:
            anchors["parting"] = t
            rec["parting"] = {"tick": t, "gt_gap_m": d}
            why.append("GT parting")
            print(f"[probe] GT parts at tick {t} by {d:.6f} m", flush=True)
        for a in anchors:
            for name, runs in cadences:
                if (name, a) not in cad_done and runs(t):
                    cad_done.add((name, a))
                    why.append(f"first {name} tick from the {a}")
        if t in check_ticks:
            why.append("asked (--check-ticks)")
        if why:
            rec["checks"].append({"tick": t, "why": why, "gt_gap_m": d,
                                  "step": one_step(jstep, tstep_check, prev,
                                                   t, ctx, chain)})
            st = rec["checks"][-1]["step"]
            if not st["stages"]["held"] and ctx.get("dump"):
                dump(ctx, prev, t)
            print(f"[probe] checked tick {t} ({'; '.join(why)}): stages "
                  f"held={st['stages']['held']} {st['stages']['differs']}",
                  flush=True)
        if rec["parting"] is not None and stop_at_parting:
            break
        if rec["parting"] is not None and after_parting is not None:
            covered = len(rec["first_differs"]) == len(discrete) and \
                len(cad_done) == len(cadences) * len(anchors)
            if (covered or t - anchors["parting"] >= after_parting) and \
                    t >= max(check_ticks, default=-1):
                break
        if until_done and bool(np.asarray(jtr.done)) and \
                bool(ttr.done[0]):
            break
        if time.perf_counter() - t_start > budget_s:
            print(f"[probe] budget spent at tick {t}", flush=True)
            rec["budget_spent"] = True
            break
    rec["ticks_run"] = t + 1
    return rec, jc, tc, tj, tt


def dump(ctx, jc, tick: int) -> None:
    """JAX's carry before ``tick`` and its teach artefacts (numpy, pickled)
    into ``ctx["dump"]``: the inputs to replay a stage that differed."""
    path = Path(ctx["dump"]) / f"{ctx['tag']}_tick{tick}.pkl"
    path.parent.mkdir(parents=True, exist_ok=True)
    keep = {k: ctx[k] for k in ("store_j", "grid_j") if k in ctx}
    with open(path, "wb") as f:
        pickle.dump(jax.tree_util.tree_map(
            np.asarray, {"tick": tick, "carry": jc, **keep}), f)
    print(f"[probe] JAX's carry before tick {tick} -> {path}", flush=True)


def stack(rows, port: bool):
    """Per-tick traces of one route -> arrays (1, T, ...)."""
    if port:
        return type(rows[0])(*(np.stack([np.asarray(x[0]) for x in xs])[None]
                               for xs in zip(*rows)))
    return type(rows[0])(*(np.stack([np.asarray(x) for x in xs])[None]
                           for xs in zip(*rows)))


class Taught(NamedTuple):
    trace: object


def verdict(records) -> str:
    """"fault" when a stage differs on JAX's inputs at a checked tick,
    "chaos" when every check held, "none found" when nothing was
    checked."""
    steps = [c["step"] for r in records for c in r["checks"]]
    if not steps:
        return "none found"
    return ("fault" if any(not s["stages"]["held"] for s in steps)
            else "chaos")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--route", required=True)
    ap.add_argument("--phase", default="teach", choices=("teach", "repeat"))
    ap.add_argument("--mode", nargs="+", default=["ours"],
                    choices=("ours", "rgbd", "stock"),
                    help="the repeat's stacks (--phase repeat), each off "
                         "the one teach")
    ap.add_argument("--ticks", type=int, default=3000,
                    help="cap on the teach's ticks (--phase teach) or each "
                         "repeat's")
    ap.add_argument("--teach-ticks", type=int, default=12000,
                    help="cap on the teach before a repeat")
    ap.add_argument("--after-parting", type=int, default=1000,
                    help="ticks a repeat runs on past the GT parting to "
                         "reach every check")
    ap.add_argument("--budget-s", type=float, default=3600.0)
    ap.add_argument("--check-ticks", type=int, nargs="+", default=[],
                    help="repeat ticks to check besides the ones the probe "
                         "picks (the lock step runs until the last)")
    ap.add_argument("--dump", type=Path, default=None,
                    help="directory: JAX's carry before each checked tick "
                         "whose stages differ, to replay them")
    ap.add_argument("--out", type=Path, default=None,
                    help="the whole record, every stage's differences")
    ap.add_argument("--case-from", type=Path, default=None,
                    help="a --dump file: write match_tick's JAX inputs at "
                         "its tick to --case-out and stop")
    ap.add_argument("--case-out", type=Path, default=None)
    ap.add_argument("--summary", type=Path, default=None,
                    help="merge a summary into this file (e.g. "
                         "artifacts/calibration_torch/divergence.json, "
                         "which the parity check attaches to missed bands)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    if args.case_from is not None:
        case = matcher_case(args.case_from, args.route, args.mode[0])
        args.case_out.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(args.case_out, **case)
        print(f"wrote {args.case_out}")
        return 0

    jc_cfg, tc_cfg = jcfg.ours(), tcfg.ours()
    jdata = jcamp.build_campaign([args.route], cfg=jc_cfg)
    tdata = tcamp.build_campaign([args.route], cfg=tc_cfg, device="cpu")
    scene_j = jax.tree_util.tree_map(lambda x: x[0], jdata.scenes_teach)
    route_j = jax.tree_util.tree_map(lambda x: x[0], jdata.routes)
    ctx = {"cfg_j": jc_cfg, "cfg_t": tc_cfg, "scene_j": scene_j,
           "route_j": route_j, "scene_t": tdata.scenes_teach,
           "route_t": tdata.routes, "dump": args.dump,
           "tag": f"{args.route}_teach"}
    step = jax.jit(lambda c, t, sc, rt: jteach.teach_step(c, t, sc, rt,
                                                          jc_cfg))

    def jstep(c, t):
        return step(c, jnp.int32(t), scene_j, route_j)

    def tstep(c, t):
        return tteach.teach_step(c, t, tdata.scenes_teach, tdata.routes,
                                 tc_cfg)

    jc = jax.tree_util.tree_map(lambda x: jnp.asarray(x, x.dtype),
                                jteach.init_teach_carry(route_j, jc_cfg))
    tc = tteach.init_teach_carry(tdata.routes, tc_cfg)
    repeat = args.phase == "repeat"
    teach, jc, tc, tj, tt = lockstep(
        jstep, tstep, jc, tc, args.teach_ticks if repeat else args.ticks,
        TEACH_DISCRETE, ctx, stage_chain, t_start, args.budget_s,
        stop_at_parting=not repeat, until_done=repeat)
    results = []
    for mode in (args.mode if repeat else [None]):
        t0 = time.perf_counter()
        res = {"route": args.route, "phase": args.phase, "mode": mode,
               "pose_atol_m": POSE_ATOL, "step_atol": STEP_ATOL,
               "teach": teach}
        records = [teach]
        if repeat:
            res["repeat"] = repeat_probe(args, mode, ctx, jdata, tdata, jc,
                                         tc, tj, tt, t0)
            records.append(res["repeat"])
        res["verdict"] = verdict(records)
        res["seconds"] = time.perf_counter() - (t0 if results else t_start)
        results.append(res)
        print(json.dumps({k: res[k] for k in ("route", "phase", "mode",
                                              "verdict", "seconds")}))
        for r in records:
            for c in r["checks"]:
                st = c["step"]
                print(f"[probe] tick {c['tick']} ({'; '.join(c['why'])}): "
                      f"whole step held={st['carry_held']} (differs "
                      f"{st['carry_differs']}); stages on JAX's inputs "
                      f"held={st['stages']['held']} (differ "
                      f"{st['stages']['differs']})")
        if args.summary is not None:
            add_summary(args.summary, res)
            print(f"added to {args.summary}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"probes": results}, indent=1,
                                       default=float) + "\n")
        print(f"wrote {args.out}")
    return 0


def summary(res: dict) -> dict:
    """The probe's findings without the stage dumps: per phase, the first
    tick at which each discrete field differs, the GT parting, and every
    checked tick with why it was checked, the parts that differ in one
    step from JAX's carry, the stages run on JAX's inputs and those that
    differ; and every stage checked at least once."""
    out = {k: res[k] for k in ("route", "phase", "mode", "verdict",
                               "seconds", "pose_atol_m", "step_atol")}
    for phase in ("teach", "repeat"):
        rec = res.get(phase)
        if rec is None:
            continue
        row = {"ticks_run": rec["ticks_run"],
               "first_differs": rec["first_differs"]}
        for k in ("first_discrete", "parting"):
            e = rec.get(k)
            if e:
                row[k] = {"tick": e["tick"], "gt_gap_m": e["gt_gap_m"],
                          "fields": e.get("fields")}
        row["checks"] = [
            {"tick": c["tick"], "why": c["why"], "gt_gap_m": c["gt_gap_m"],
             "whole_step_differs": c["step"]["carry_differs"],
             "stages_checked": c["step"]["stages"]["checked"],
             "stages_held": c["step"]["stages"]["held"],
             "stages_differ": c["step"]["stages"]["differs"]}
            for c in rec["checks"]]
        row["stages_checked"] = sorted({s for c in row["checks"]
                                        for s in c["stages_checked"]})
        if "waypoints" in rec:
            row["waypoints"] = rec["waypoints"]
        out[phase] = row
    return out


def add_summary(path: Path, res: dict) -> None:
    """Merge the probe's summary into ``path`` (one entry a route, mode and
    phase)."""
    entry = summary(res)
    probes = (json.loads(path.read_text())["probes"] if path.is_file()
              else [])
    key = (entry["route"], entry["mode"], entry["phase"])
    probes = [p for p in probes
              if (p["route"], p["mode"], p["phase"]) != key] + [entry]
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"probes": probes}, indent=1) + "\n")


def mode_configs(mode: str):
    """(JAX config, port config) of a repeat mode."""
    from nclt_slam_tpu.baselines import configs as jbase
    from nclt_slam_tpu_torch.baselines import configs as tbase

    make = {"ours": (jcfg.ours, tcfg.ours),
            "rgbd": (jbase.rgbd_no_imu, tbase.rgbd_no_imu),
            "stock": (jbase.stock_nav2, tbase.stock_nav2)}[mode]
    return make[0](), make[1]()


def matcher_case(dump: Path, route: str, mode: str) -> dict:
    """``match_tick``'s JAX inputs at a tick dumped by ``--dump`` (the
    route's ``mode`` repeat), for a test to replay: the carry before the
    tick stepped through the tick's stages up to the matcher, and the
    landmark store cut to what the matcher can read (every landmark's
    camera pose and count; descriptors, points and flags only of the
    landmarks near the query, zeros elsewhere).  Keys ``store_<field>``,
    ``obs_<field>``, ``xy``, ``yaw``, ``query``, ``key``, ``extra``,
    ``tick``, ``route``, ``mode``."""
    from nclt_slam_tpu.rollout import repeat as jrep

    with open(dump, "rb") as f:
        d = pickle.load(f)
    cj, ct = mode_configs(mode)
    jdata = jcamp.build_campaign([route], cfg=jcfg.ours())
    tdata = tcamp.build_campaign([route], cfg=tcfg.ours(), device="cpu")
    store_j = jax.tree_util.tree_map(jnp.asarray, d["store_j"])
    grid_j = jnp.asarray(d["grid_j"])
    scene_j = jax.tree_util.tree_map(lambda x: x[0], jdata.scenes_repeat)
    route_j = jax.tree_util.tree_map(lambda x: x[0], jdata.routes)
    step = jax.jit(lambda c, t: jrep.repeat_step(c, t, scene_j, route_j,
                                                 grid_j, store_j, cj))
    ctx = dict(cfg_j=cj, cfg_t=ct, scene_j=scene_j, route_j=route_j,
               scene_t=tdata.scenes_repeat, route_t=tdata.routes,
               store_j=store_j, store_jt=batch1(store_j), grid_j=grid_j,
               grid_jt=torch.from_numpy(np.array(grid_j))[None],
               jstep=lambda c, t: step(c, jnp.int32(t)), dump=None,
               tag=f"{route}_{mode}")
    tick = int(d["tick"])
    repeat_stage_chain(jax.tree_util.tree_map(jnp.asarray, d["carry"]),
                       tick, ctx)
    store, obs, xy, yaw, query, key, extra = (
        jax.tree_util.tree_map(np.asarray, x)
        for x in ctx["matcher_inputs"])
    lm = cj.landmarks
    near = (np.arange(lm.max_landmarks) < store.count) & (np.hypot(
        *(store.cam_pos[:, :2] - xy).T) < lm.candidate_radius_m + 1.0)
    out = {f"store_{f}": v for f, v in store._asdict().items()}
    for f in ("desc", "p3d_cam", "uv", "feat_valid", "n_feats"):
        out[f"store_{f}"] = np.where(
            near.reshape((-1,) + (1,) * (out[f"store_{f}"].ndim - 1)),
            out[f"store_{f}"], 0).astype(out[f"store_{f}"].dtype)
    out.update({f"obs_{f}": v for f, v in obs._asdict().items()})
    out.update(xy=xy, yaw=yaw, query=query, key=key, extra=extra,
               tick=tick, route=route, mode=mode)
    return out


def repeat_probe(args, mode, ctx, jdata, tdata, jc, tc, tj, tt,
                 t_start) -> dict:
    """Each package's waypoints from its own teach, then both repeats in
    lock step from the same seed."""
    from nclt_slam_tpu.mapping.occupancy import occupancy_trinary as jtri
    from nclt_slam_tpu.rollout import repeat as jrep
    from nclt_slam_tpu_torch.mapping.occupancy import \
        occupancy_trinary as ttri
    from nclt_slam_tpu_torch.rollout import repeat as trep

    cj, ct = mode_configs(mode)
    teach_cfg_j = ctx["cfg_j"]
    grid_j = jtri(jc.grid, teach_cfg_j.map)
    grid_t = ttri(tc.grid, ctx["cfg_t"].map)
    wj, nj = jcamp.teach_waypoints(jdata, Taught(stack(tj, False)),
                                   teach_cfg_j)
    wt, nt = tcamp.teach_waypoints(tdata, Taught(stack(tt, True)),
                                   ctx["cfg_t"])
    wj, nj = jcamp.apply_stock_projection(grid_j[None], wj, nj, cj)
    wt, nt = tcamp.apply_stock_projection(grid_t, wt, nt, ct)
    wj0, nj0 = np.asarray(wj)[0], int(np.asarray(nj)[0])
    wps = {"n_port": int(nt[0]), "n_jax": nj0,
           "grid_cells_differing": int((grid_t[0].numpy() !=
                                        np.asarray(grid_j)).sum())}
    if wps["n_port"] == nj0:
        wps["max_abs_m"] = float(np.abs(wt[0, :nj0].numpy()
                                        - wj0[:nj0]).max())
    print(f"[probe] {mode} waypoints {wps}", flush=True)
    scene_rj = jax.tree_util.tree_map(lambda x: x[0], jdata.scenes_repeat)
    route_j = ctx["route_j"]
    store_j = jc.store
    step = jax.jit(lambda c, t, sc, rt, g, s: jrep.repeat_step(
        c, t, sc, rt, g, s, cj))

    def jstep(c, t):
        return step(c, jnp.int32(t), scene_rj, route_j, grid_j, store_j)

    store_jt = batch1(store_j)
    grid_jt = torch.from_numpy(np.array(grid_j))[None]
    rctx = dict(ctx, cfg_j=cj, cfg_t=ct, scene_j=scene_rj,
                scene_t=tdata.scenes_repeat, store_j=store_j,
                store_jt=store_jt, grid_j=grid_j, grid_jt=grid_jt,
                jstep=jstep, tag=f"{args.route}_{mode}")

    def tstep_own(c, t):
        return trep.repeat_step(c, t, tdata.scenes_repeat, tdata.routes,
                                grid_t, tc.store, ct)

    def tstep_jax_artefacts(c, t):
        return trep.repeat_step(c, t, tdata.scenes_repeat, tdata.routes,
                                grid_jt, store_jt, ct)

    cadences = [("costmap and dispatch_plan",
                 lambda t: t % cj.map.update_period == 0)]
    if cj.mode.use_anchors:
        cadences.append(("matcher",
                         lambda t: t % cj.landmarks.tick_period == 0))
    if cj.planner.coarse_seed:
        cadences.append(("coarse_potential",
                         lambda t: t % cj.planner.replan_period == 1))
    if cj.vio.enable_local_ba:
        cadences.append(("local_ba", lambda t: t % 10 == 3))
    jrc = jax.tree_util.tree_map(lambda x: jnp.asarray(x, x.dtype),
                                 jrep.init_repeat_carry(route_j, wj0, nj0,
                                                        cj))
    trc = trep.init_repeat_carry(tdata.routes, wt, nt, ct)
    # the lock step runs each package off its own teach; the one-step
    # checks hand the port JAX's carry and JAX's teach artefacts
    rec, *_ = lockstep(jstep, tstep_own, jrc, trc, args.ticks,
                       REPEAT_DISCRETE, rctx, repeat_stage_chain, t_start,
                       args.budget_s, stop_at_parting=False,
                       tstep_check=tstep_jax_artefacts, cadences=cadences,
                       after_parting=args.after_parting,
                       check_ticks=set(args.check_ticks))
    rec["waypoints"] = wps
    return rec


if __name__ == "__main__":
    sys.exit(main())
