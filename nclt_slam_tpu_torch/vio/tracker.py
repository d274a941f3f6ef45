"""RGB-D-inertial visual odometry (``nclt_slam_tpu/vio/tracker.py``).

Per 10 Hz vision frame, for every route of the batch:
1. predict the body state by IMU preintegration over the 200 Hz block (or
   constant velocity without IMU);
2. match the frame's descriptors to the persistent map (mutual Hamming,
   kernel K1: all routes in one launch);
3. motion-only Gauss-Newton on the 6-dof body pose (Huber-weighted pixel
   reprojection + depth residuals of the matched map points), with the
   Jacobian of the residual at delta = 0 written out analytically;
4. relocalization by 3-D/3-D Kabsch while lost;
5. map maintenance (running-mean refinement, insertion of novel features,
   eviction of stale slots), tracking-lost detection, the backend
   world-registration event model and the keyframe ring.

The VIO world frame is the spawn body frame (FLU).  ``emit_slam_pose``
converts to the ORB-SLAM3 convention (camera pose in the first-camera
world) that the v55 relay consumes.

Scatters with repeated indices.  ``map.at[m_idx].set(v)`` in the JAX package
writes every live feature's row, matched or not, and unmatched rows share
slots with matched ones (an invalid row's nearest slot is 0).  XLA on the
CPU applies the updates in row order, so the last row wins; ``_set_last``
reproduces that order deterministically (the winning row per slot is a
``scatter_reduce`` max of row indices, then a gather), where a plain
``index_put_`` on CUDA would leave the winner undefined.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nclt_slam_tpu_torch.config import CameraConfig, VioConfig
from nclt_slam_tpu_torch.core import prng
from nclt_slam_tpu_torch.core.quat import (
    mat_to_quat,
    quat_conj,
    quat_mul,
    quat_to_mat,
    skew,
    so3_exp,
    so3_log,
)
from nclt_slam_tpu_torch.sensors.depth import R_BASE_CAM, base_to_cam, cam_to_base
from nclt_slam_tpu_torch.sensors.features import Observation, _take, cross_check_match
from nclt_slam_tpu_torch.vio.preintegration import empty_preint, integrate_block, propagate

MAP_CAP = 384
# Stored observations per keyframe (the local-BA window's factors)
KF_OBS = 192
K_INS = 24          # map insertions allowed per frame


class VioAux(NamedTuple):
    """Per-frame tracking telemetry (traced by the rollout)."""

    n_desc: torch.Tensor   # (B,) descriptor matches, pre-projection-gate
    n_match: torch.Tensor  # (B,) matches surviving the projection gate
    n_ins: torch.Tensor    # (B,) map points inserted this frame
    flags: torch.Tensor    # (B,) bit0 enough, bit1 finite, bit2 plausible,
    #                        bit3 lost, bit4 reloc, bit5 backend event


class VioState(NamedTuple):
    pos: torch.Tensor        # (B, 3) body position in VIO world (spawn frame)
    vel: torch.Tensor        # (B, 3)
    q: torch.Tensor          # (B, 4) world_from_body
    map_xyz: torch.Tensor    # (B, MAP_CAP, 3) map points (VIO world)
    map_desc: torch.Tensor   # (B, MAP_CAP, W) int64 holding uint32
    map_valid: torch.Tensor  # (B, MAP_CAP)
    map_age: torch.Tensor    # (B, MAP_CAP) frames since last seen
    map_obs: torch.Tensor    # (B, MAP_CAP) observation count
    next_slot: torch.Tensor  # (B,) int32 ring insertion cursor
    lost: torch.Tensor       # (B,) bool
    implaus_streak: torch.Tensor  # (B,) int32
    n_tracked: torch.Tensor  # (B,) int32 matches in the last frame
    frames: torch.Tensor     # (B,) int32
    kf_pos: torch.Tensor       # (B, K, 3)
    kf_quat: torch.Tensor      # (B, K, 4)
    kf_valid: torch.Tensor     # (B, K)
    kf_ptr: torch.Tensor       # (B,) int32 ring cursor (newest = ptr-1)
    kf_obs_slot: torch.Tensor  # (B, K, KF_OBS) map slot ids
    kf_obs_uv: torch.Tensor    # (B, K, KF_OBS, 2)
    kf_obs_z: torch.Tensor     # (B, K, KF_OBS)
    kf_obs_valid: torch.Tensor  # (B, K, KF_OBS)
    last_kf_pos: torch.Tensor  # (B, 3)
    emit_scale: torch.Tensor   # (B,) reported-trajectory scale
    emit_off: torch.Tensor     # (B, 3) reported-trajectory offset
    dist_since_event: torch.Tensor  # (B,)
    stress_streak: torch.Tensor     # (B,) int32
    starve_streak: torch.Tensor     # (B,) int32


def init_vio(desc_words: int, window_kf: int, batch: int,
             device) -> VioState:
    K, B = window_kf, batch
    z = dict(device=device)
    zi = torch.zeros(B, dtype=torch.int32, **z)
    q = torch.zeros(B, 4, **z)
    q[:, 3] = 1.0
    kf_quat = torch.zeros(B, K, 4, **z)
    kf_quat[..., 3] = 1.0
    return VioState(
        pos=torch.zeros(B, 3, **z), vel=torch.zeros(B, 3, **z), q=q,
        map_xyz=torch.zeros(B, MAP_CAP, 3, **z),
        map_desc=torch.zeros(B, MAP_CAP, desc_words, dtype=torch.int64, **z),
        map_valid=torch.zeros(B, MAP_CAP, dtype=torch.bool, **z),
        map_age=torch.zeros(B, MAP_CAP, dtype=torch.int32, **z),
        map_obs=torch.zeros(B, MAP_CAP, dtype=torch.int32, **z),
        next_slot=zi, lost=torch.zeros(B, dtype=torch.bool, **z),
        implaus_streak=zi.clone(), n_tracked=zi.clone(), frames=zi.clone(),
        kf_pos=torch.zeros(B, K, 3, **z), kf_quat=kf_quat,
        kf_valid=torch.zeros(B, K, dtype=torch.bool, **z),
        kf_ptr=zi.clone(),
        kf_obs_slot=torch.zeros(B, K, KF_OBS, dtype=torch.int32, **z),
        kf_obs_uv=torch.zeros(B, K, KF_OBS, 2, **z),
        kf_obs_z=torch.zeros(B, K, KF_OBS, **z),
        kf_obs_valid=torch.zeros(B, K, KF_OBS, dtype=torch.bool, **z),
        last_kf_pos=torch.full((B, 3), 1e9, **z),
        emit_scale=torch.ones(B, **z),
        emit_off=torch.zeros(B, 3, **z),
        dist_since_event=torch.zeros(B, **z),
        stress_streak=zi.clone(), starve_streak=zi.clone(),
    )


def _norm(x, keepdim=False):
    return torch.linalg.vector_norm(x, dim=-1, keepdim=keepdim)


def _t_bc(cam: CameraConfig, device):
    return torch.tensor([cam.cam_offset_fwd, 0.0, cam.cam_offset_up],
                        device=device)


def _project(p_cam, cam: CameraConfig):
    z = p_cam[..., 2].clamp_min(0.1)
    return torch.stack([cam.fx * p_cam[..., 0] / z + cam.cx,
                        cam.fy * p_cam[..., 1] / z + cam.cy], -1)


def _pose_gn(pos0, q0, X_w, uv_obs, z_obs, w_pt, cam: CameraConfig,
             cfg: VioConfig, prior_pos=None, prior_q=None,
             w_prior_pos: float = 0.0, w_prior_rot: float = 0.0):
    """Motion-only GN on the body pose (B, 3) / (B, 4) against matched map
    points X_w (B, M, 3), uv_obs (B, M, 2), camera-frame depth z_obs
    (B, M), weights w_pt (B, M) (0 for unmatched); ``prior_*`` add the
    inertial prior factor.

    The residual of a point is r = [u - u_obs, v - v_obs, (z - z_obs) /
    sigma_z] with p_base = R(q exp(dθ))^T (X - pos - dp) - t_bc and
    p_cam = p_base @ R_BASE_CAM.  At delta = 0, d p_base / dθ = [y]x with
    y = R^T (X - pos) and d p_base / dp = -R^T, which the chain rule through
    the axis permutation and the pinhole carries to r — the same Jacobian
    the JAX package takes with ``jacfwd``, to rounding."""
    B, M, _ = X_w.shape
    dev = X_w.device
    t_bc = _t_bc(cam, dev)
    sigma_z = (cam.depth_noise_rel_per_m * z_obs ** 2).clamp_min(0.05)
    eye6 = torch.eye(6, device=dev)
    if prior_pos is not None:
        diag = torch.tensor([w_prior_rot] * 3 + [w_prior_pos] * 3,
                            device=dev)
    pos, q = pos0, q0
    for _ in range(cfg.gn_iters):
        R = quat_to_mat(q)                                 # (B, 3, 3)
        y = torch.matmul(X_w - pos[:, None], R)            # (B, M, 3)
        p_cam = base_to_cam(y - t_bc)
        x_c, y_c, z = p_cam.unbind(-1)
        zc = z.clamp_min(0.1)
        u = cam.fx * x_c / zc + cam.cx
        v = cam.fy * y_c / zc + cam.cy
        r = torch.stack([u - uv_obs[..., 0], v - uv_obs[..., 1],
                         (z - z_obs) / sigma_z], -1)       # (B, M, 3)

        # d p_base / d[θ, p] (B, M, 3, 6), then rows permuted into p_cam
        Jb = torch.cat([skew(y), (-R.transpose(-1, -2))[:, None].expand(
            B, M, 3, 3)], -1)
        Jc = base_to_cam(Jb.transpose(-1, -2)).transpose(-1, -2)
        act = (z > 0.1).to(torch.float32)[..., None]
        dz = Jc[..., 2, :]
        du = cam.fx * (Jc[..., 0, :] / zc[..., None]
                       - (x_c / (zc * zc))[..., None] * dz * act)
        dv = cam.fy * (Jc[..., 1, :] / zc[..., None]
                       - (y_c / (zc * zc))[..., None] * dz * act)
        J = torch.stack([du, dv, dz / sigma_z[..., None]], -2)  # (B,M,3,6)

        # Huber weights on the pixel residual norm
        r_norm = _norm(r[..., :2])
        hub = torch.where(r_norm <= cfg.huber_px, torch.ones_like(r_norm),
                          cfg.huber_px / r_norm.clamp_min(1e-6))
        Jw = J * (w_pt * hub)[..., None, None]
        Jf, Jwf = J.reshape(B, M * 3, 6), Jw.reshape(B, M * 3, 6)
        H = torch.matmul(Jwf.transpose(-1, -2), Jf) + cfg.lm_damping * eye6
        g = torch.matmul(Jwf.transpose(-1, -2), r.reshape(B, M * 3, 1))[..., 0]
        if prior_pos is not None:
            r_rot_p = so3_log(quat_mul(quat_conj(prior_q), q))
            H = H + torch.diag(diag)
            g = g + diag * torch.cat([r_rot_p, pos - prior_pos], -1)
        # solve_ex: no host synchronisation on the error flag
        delta = -torch.linalg.solve_ex(H, g[..., None])[0][..., 0]
        # trust region + NaN guard: a degenerate window must not poison
        # the state
        delta = torch.nan_to_num(delta, nan=0.0, posinf=0.0, neginf=0.0)
        delta = delta * torch.clamp_max(1.0 / (_norm(delta, True) + 1e-9),
                                        1.0)
        pos = pos + delta[:, 3:]
        q = quat_mul(q, so3_exp(delta[:, :3]))
    return pos, q / _norm(q, True)


def _set_last(base, idx, vals):
    """``base.at[idx].set(vals)`` per route with XLA-CPU's order for
    repeated indices: the last row wins.  base (B, N, ...), idx (B, A),
    vals (B, A, ...)."""
    B, N = base.shape[:2]
    A = idx.shape[1]
    rows = torch.arange(A, device=idx.device).expand(B, A)
    winner = torch.full((B, N), -1, dtype=torch.int64, device=idx.device)
    winner = winner.scatter_reduce(1, idx, rows, "amax")
    hit = (winner >= 0).reshape((B, N) + (1,) * (base.dim() - 2))
    return torch.where(hit, _take(vals, winner.clamp_min(0)), base)


def _set_unique(base, idx, vals):
    """``base.at[idx].set(vals)`` per route for distinct indices."""
    out = base.clone()
    out[torch.arange(base.shape[0], device=idx.device)[:, None], idx] = vals
    return out


def _argsort_false_first(mask):
    """``jnp.argsort(~mask)``: the True rows first, each group in index
    order."""
    return torch.sort((~mask).to(torch.uint8), dim=-1, stable=True).indices


def vio_frame(state: VioState, obs: Observation, imu_block_meas,
              dt_frame: float, gravity, cam: CameraConfig, cfg: VioConfig,
              use_imu: bool, key=None):
    """One VIO frame for every route.  imu_block_meas (B, S, 6)
    [accel | gyro] since the last frame; gravity (3,); ``key`` (B, 2)
    drives the backend-event model (None freezes the world registration).
    Returns (state, slam_ok (B,), aux)."""
    B = state.pos.shape[0]
    dev = state.pos.device
    f32 = torch.float32
    # ---- predict ----
    if use_imu:
        S = imu_block_meas.shape[1]
        pre = integrate_block(empty_preint(B, dev), imu_block_meas[..., :3],
                              imu_block_meas[..., 3:], dt_frame / S)
        pos_pred, vel_pred, q_pred = propagate(state.pos, state.vel, state.q,
                                               pre, gravity)
    else:
        pos_pred = state.pos + state.vel * dt_frame
        vel_pred, q_pred = state.vel, state.q

    # ---- match to map (K1) ----
    m_idx, matched, best_d = cross_check_match(
        obs.desc, obs.valid, state.map_desc, state.map_valid,
        return_dist=True, site="vio")
    X = _take(state.map_xyz, m_idx)                        # (B, K, 3)

    # projection-guided gating under the PREDICTED pose
    t_bc = _t_bc(cam, dev)
    R_pred = quat_to_mat(q_pred)
    p_cam_pred = base_to_cam(torch.matmul(X - pos_pred[:, None], R_pred)
                             - t_bc)
    uv_pred = _project(p_cam_pred, cam)
    proj_ok = (_norm(uv_pred - obs.uv) < cfg.proj_gate_px) & \
        (p_cam_pred[..., 2] > 0.1)
    n_desc = matched.sum(1)
    desc_matched = matched
    matched = matched & proj_ok
    n_match = matched.sum(1)
    w_pt = matched.to(f32)

    # ---- motion-only GN ----
    use_prior = use_imu and cfg.use_inertial_prior
    w_pp = 1.0 / cfg.inertial_prior_pos_std ** 2 if use_prior else 0.0
    w_pr = 1.0 / cfg.inertial_prior_rot_std ** 2 if use_prior else 0.0
    pos_opt, q_opt = _pose_gn(pos_pred, q_pred, X, obs.uv, obs.p3d_cam[..., 2],
                              w_pt, cam, cfg,
                              prior_pos=pos_pred if use_prior else None,
                              prior_q=q_pred, w_prior_pos=w_pp,
                              w_prior_rot=w_pr)
    finite = torch.isfinite(pos_opt).all(-1) & torch.isfinite(q_opt).all(-1)
    # motion-model plausibility, with a consensus override after 3 frames
    plausible = _norm(pos_opt - pos_pred) <= cfg.max_frame_jump_m
    consensus = finite & ~plausible & (n_match >= 30)
    implaus_streak = torch.where(consensus, state.implaus_streak + 1,
                                 torch.zeros_like(state.implaus_streak))
    plausible = plausible | (consensus & (implaus_streak >= 3))
    enough = (n_match >= 8) & finite & plausible
    # lost: freeze the emitted position, keep integrating the gyro
    pos_new = torch.where(enough[:, None], pos_opt, state.pos)
    q_new = torch.where(enough[:, None], q_opt, q_pred / _norm(q_pred, True))

    vel_vis = (pos_new - state.pos) / dt_frame
    vel_new = torch.where(enough[:, None], 0.7 * vel_vis + 0.3 * vel_pred,
                          torch.zeros_like(vel_vis))
    vel_new = vel_new * torch.clamp_max(2.0 / (_norm(vel_new, True) + 1e-9),
                                        1.0)

    # ---- relocalization: descriptor-only matches, 3-D/3-D Kabsch ----
    from nclt_slam_tpu_torch.landmarks.matcher import _kabsch

    p_base_obs = cam_to_base(obs.p3d_cam) + t_bc
    w0 = desc_matched.to(f32)
    R1, t1 = _kabsch(p_base_obs, X, w0)
    r1 = _norm(torch.matmul(p_base_obs, R1.transpose(-1, -2))
               + t1[:, None] - X)
    R2, t2 = _kabsch(p_base_obs, X, w0 * (r1 < 1.0))
    r2 = _norm(torch.matmul(p_base_obs, R2.transpose(-1, -2))
               + t2[:, None] - X)
    inl = desc_matched & (r2 < 0.5)
    reloc_ok = (inl.sum(1) >= 20) & torch.isfinite(t2).all(-1) & \
        torch.isfinite(R2).flatten(1).all(-1)
    reloc = state.lost & reloc_ok & ~enough
    pos_new = torch.where(reloc[:, None], t2, pos_new)
    q_new = torch.where(reloc[:, None], mat_to_quat(R2), q_new)
    vel_new = torch.where(reloc[:, None], torch.zeros_like(vel_new), vel_new)

    # ---- map maintenance ----
    R_wb = quat_to_mat(q_new)
    X_new = torch.matmul(p_base_obs, R_wb.transpose(-1, -2)) + pos_new[:, None]
    # running-mean refinement of matched points while tracking is healthy
    refine = matched & enough[:, None]
    alpha = 1.0 / (1.0 + _take(state.map_obs, m_idx).to(f32))
    X_refined = (1.0 - alpha[..., None]) * X + alpha[..., None] * X_new
    map_xyz = _set_last(state.map_xyz, m_idx,
                        torch.where(refine[..., None], X_refined, X))
    map_obs = state.map_obs.scatter_add(1, m_idx, refine.to(torch.int32))

    # insert only genuinely new features (unmatched AND descriptor-novel)
    novel = best_d > 80
    insert = obs.valid & ~matched & novel & (obs.p3d_cam[..., 2] > 0.3)
    take = _argsort_false_first(insert)[:, :K_INS]
    ins_ins = _take(insert, take)
    ins_ok = ins_ins & enough[:, None]
    # eviction: invalid slots first, then oldest-unseen; points matched
    # this frame are protected
    protected = torch.zeros(B, MAP_CAP, dtype=torch.int32, device=dev) \
        .scatter_add(1, m_idx, matched.to(torch.int32)) > 0
    evict = torch.where(~state.map_valid, torch.full((), 1e9, device=dev),
                        torch.where(protected, torch.full((), -1.0, device=dev),
                                    state.map_age.to(f32)))
    # lax.top_k: largest first, the lowest index first among ties
    slots = torch.sort(evict, dim=-1, descending=True, stable=True) \
        .indices[:, :K_INS]
    X_take, d_take = _take(X_new, take), _take(obs.desc, take)
    first = state.frames == 0
    boot_ok = ins_ins & first[:, None]
    map_desc, map_valid = state.map_desc, state.map_valid
    for ok in (ins_ok, boot_ok):
        okx = ok[..., None]
        map_xyz = _set_unique(map_xyz, slots, torch.where(
            okx, X_take, _take(map_xyz, slots)))
        map_desc = _set_unique(map_desc, slots, torch.where(
            okx, d_take, _take(map_desc, slots)))
        map_valid = _set_unique(map_valid, slots,
                                _take(map_valid, slots) | ok)
        map_obs = _set_unique(map_obs, slots, torch.where(
            ok, torch.ones_like(slots, dtype=torch.int32),
            _take(map_obs, slots)))
    ins_any = ins_ok | boot_ok
    n_ins = ins_any.sum(1)

    # ages: matched points refresh, fresh insertions start at 0, others age
    # out after 600 frames; the map is frozen in time while LOST
    age = state.map_age + (~state.lost).to(torch.int32)[:, None]
    age = _set_last(age, m_idx, torch.where(matched, torch.zeros_like(
        m_idx, dtype=torch.int32), _take(age, m_idx)))
    age = _set_unique(age, slots, torch.where(ins_any, torch.zeros_like(
        slots, dtype=torch.int32), _take(age, slots)))
    map_valid = map_valid & (age < 600)

    lost = ~first & (n_match < 8) & ~reloc

    # ---- backend world-registration events (VioConfig snap_*) ----
    rot_rate = _norm(so3_log(quat_mul(quat_conj(state.q), q_new))) / \
        max(dt_frame, 1e-3)
    stressed = (n_match < cfg.snap_stress_match_n) | \
        (rot_rate > cfg.snap_stress_rot)
    zi = torch.zeros_like(state.stress_streak)
    stress_streak = torch.where(stressed & ~first, state.stress_streak + 1, zi)
    starved = n_match < cfg.snap_starve_match_n
    starve_streak = torch.where(starved & ~first, state.starve_streak + 1, zi)
    dist_since = state.dist_since_event + torch.where(
        enough, _norm(pos_new - state.pos), torch.zeros_like(rot_rate))
    if key is not None and cfg.snap_p_stressed > 0.0:
        k_ev, k_scale, k_off = prng.split(key, 3).unbind(-2)
        armed = ((stress_streak >= cfg.snap_stress_min)
                 | (starve_streak >= cfg.snap_starve_min)) & \
            (dist_since >= cfg.snap_min_dist_m)
        fire = (armed & (prng.uniform(k_ev) < cfg.snap_p_stressed)) | reloc
        snap_std = torch.clamp_max(cfg.snap_frac * dist_since, cfg.snap_cap_m)
        off_delta = snap_std[:, None] * prng.normal(k_off, (3,)) * \
            torch.tensor([1.0, 1.0, 0.2], device=dev)
        emit_off = state.emit_off + torch.where(fire[:, None], off_delta,
                                                torch.zeros_like(off_delta))
        scale_next = 1.0 + cfg.scale_revert * (state.emit_scale - 1.0) + \
            cfg.scale_jump_std * prng.normal(k_scale)
        emit_scale = torch.where(fire, scale_next, state.emit_scale)
        dist_since = torch.where(fire, torch.zeros_like(dist_since),
                                 dist_since)
        stress_streak = torch.where(fire, zi, stress_streak)
        starve_streak = torch.where(fire, zi, starve_streak)
    else:
        fire = torch.zeros_like(lost)
        emit_off, emit_scale = state.emit_off, state.emit_scale

    # ---- keyframe push (every 0.5 m of tracked motion) ----
    K = state.kf_pos.shape[1]
    push = enough & (_norm(pos_new - state.last_kf_pos) >= 0.5)
    at = (torch.arange(K, device=dev) == (state.kf_ptr % K)[:, None]) & \
        push[:, None]                                      # (B, K)
    m_order = _argsort_false_first(matched)[:, :KF_OBS]

    def kf_set(old, new):
        m = at.reshape(at.shape + (1,) * (old.dim() - 2))
        return torch.where(m, new[:, None], old)

    new_state = VioState(
        pos=pos_new, vel=vel_new, q=q_new,
        map_xyz=map_xyz, map_desc=map_desc, map_valid=map_valid,
        map_age=age, map_obs=map_obs,
        next_slot=(state.next_slot + n_ins.to(torch.int32)) % MAP_CAP,
        lost=lost, implaus_streak=implaus_streak,
        n_tracked=n_match.to(torch.int32), frames=state.frames + 1,
        kf_pos=kf_set(state.kf_pos, pos_new),
        kf_quat=kf_set(state.kf_quat, q_new),
        kf_valid=state.kf_valid | at,
        kf_ptr=state.kf_ptr + push.to(torch.int32),
        kf_obs_slot=kf_set(state.kf_obs_slot,
                           _take(m_idx, m_order).to(torch.int32)),
        kf_obs_uv=kf_set(state.kf_obs_uv, _take(obs.uv, m_order)),
        kf_obs_z=kf_set(state.kf_obs_z, _take(obs.p3d_cam[..., 2], m_order)),
        kf_obs_valid=kf_set(state.kf_obs_valid, _take(matched, m_order)),
        last_kf_pos=torch.where(push[:, None], pos_new, state.last_kf_pos),
        emit_scale=emit_scale, emit_off=emit_off,
        dist_since_event=dist_since, stress_streak=stress_streak,
        starve_streak=starve_streak)
    i32 = torch.int32
    aux = VioAux(
        n_desc=n_desc.to(i32), n_match=n_match.to(i32), n_ins=n_ins.to(i32),
        flags=(enough.to(i32) | (finite.to(i32) << 1)
               | (plausible.to(i32) << 2) | (lost.to(i32) << 3)
               | (reloc.to(i32) << 4) | (fire.to(i32) << 5)))
    return new_state, ~lost, aux


def emit_body_pos(state: VioState):
    """Body position as REPORTED at the SLAM pose interface (through the
    current world registration) — what the drift monitor and the relay
    see.  (B, 3)."""
    return state.emit_scale[:, None] * state.pos + state.emit_off


def emit_slam_pose(state: VioState, cam: CameraConfig):
    """VIO body pose -> ORB-SLAM3-convention camera pose (t (B, 3), quat
    xyzw (B, 4)) in the first-camera world frame, as the relay consumes
    it: T_slam = T_FLU_FROM_CAM^-1 @ T_nav @ T_FLU_FROM_CAM, whose 3x3
    block is R_BASE_CAM (a signed permutation, so the products are exact)."""
    R_wb = quat_to_mat(state.q)
    t_nav = emit_body_pos(state) + torch.matmul(
        R_wb, _t_bc(cam, state.q.device)[:, None])[..., 0]
    C = torch.tensor(R_BASE_CAM, device=state.q.device)
    R_slam = C.transpose(-1, -2) @ R_wb @ C
    return base_to_cam(t_nav), mat_to_quat(R_slam)


TRUST_M = 0.5   # local BA: the largest keyframe move of an accepted solve
WILD_M = 5.0    # local BA: a solve that moves a keyframe further is discarded


def local_ba(state: VioState, cam: CameraConfig, cfg: VioConfig) -> VioState:
    """Sliding-window local BA over the keyframe ring, for every route (one
    window a route, one launch of kernel K3), run at a uniform cadence by
    the rollout when ``VioConfig.enable_local_ba`` is set.

    A window's landmark set is the newest keyframe's observed map slots;
    the observation weights of the older keyframes come from slot-id
    matching, so all shapes stay fixed.  The correction is scaled so that
    the largest keyframe move is at most TRUST_M (a solve beyond WILD_M is
    discarded); optimized keyframes update the ring and optimized points
    write back to the map, each point gated on its own (seen by two
    keyframes, moved at most 1 m).  The live pose is not touched: the
    tracker benefits through the refined map and keyframes only.  A route
    whose window fails the ``enough`` gate keeps its state."""
    from nclt_slam_tpu_torch.vio.ba import BAProblem, solve_ba

    B, K = state.kf_pos.shape[:2]
    S = state.kf_obs_slot.shape[2]
    dev = state.kf_pos.device
    f32 = torch.float32
    newest = ((state.kf_ptr - 1) % K).long()
    slots = _take(state.kf_obs_slot, newest[:, None])[:, 0].long()  # (B, P)
    pts0 = _take(state.map_xyz, slots)

    # (B, K, P) observation weights by slot-id equality against each
    # keyframe's observations; src is the first matching observation (0
    # where there is none, as an argmax over an all-false column)
    pair_ok = (state.kf_obs_slot[:, :, :, None] == slots[:, None, None, :]) \
        & state.kf_obs_valid[:, :, :, None]                # (B, K, S, P)
    rows = torch.arange(S, dtype=torch.int32, device=dev)[:, None]
    src = torch.where(pair_ok, rows, torch.full_like(rows, S)).amin(2)
    seen = src < S
    src = torch.where(seen, src, torch.zeros_like(src)).long()
    obs_w = (seen & state.kf_valid[:, :, None]).to(f32)
    obs_uv = torch.gather(state.kf_obs_uv, 2,
                          src[..., None].expand(B, K, src.shape[2], 2))
    obs_z = torch.gather(state.kf_obs_z, 2, src)

    # order the ring chronologically (oldest..newest) for the rel factors
    order = ((state.kf_ptr[:, None] + torch.arange(K, device=dev)) % K).long()
    kf_pos = _take(state.kf_pos, order)
    kf_quat = _take(state.kf_quat, order)
    kf_ok = _take(state.kf_valid, order)
    obs_w = _take(obs_w, order) * kf_ok[:, :, None].to(f32)
    obs_uv = _take(obs_uv, order)
    obs_z = _take(obs_z, order)

    # relative factors from the current estimates (a regularizer holding
    # the window's shape while reprojection refines it)
    dq = quat_mul(quat_conj(kf_quat[:, :-1]), kf_quat[:, 1:])
    dp = torch.matmul((kf_pos[:, 1:] - kf_pos[:, :-1])[..., None, :],
                      quat_to_mat(kf_quat[:, :-1]))[..., 0, :]
    # anchor each point at its running-mean estimate, one pixel^2 residual
    # per prior re-observation (capped: very old points stay adjustable)
    pt_prior = 0.5 * _take(state.map_obs, slots).clamp_max(100).to(f32)
    prob = BAProblem(kf_pos=kf_pos, kf_quat=kf_quat, points=pts0,
                     obs_uv=obs_uv, obs_z=obs_z, obs_w=obs_w,
                     rel_dp=dp, rel_dq=dq, w_rel=10.0, pt_prior_w=pt_prior)
    res = solve_ba(prob, cam, cfg, iters=3, site="local_ba")

    finite = torch.isfinite(res.kf_pos).flatten(1).all(1) & \
        torch.isfinite(res.kf_quat).flatten(1).all(1) & \
        torch.isfinite(res.points).flatten(1).all(1)
    d_kf = _norm(res.kf_pos - kf_pos).amax(1)              # (B,)
    scale = torch.clamp_max(TRUST_M / d_kf.clamp_min(1e-6), 1.0)[:, None, None]
    ba_pos = kf_pos + scale * (res.kf_pos - kf_pos)
    drot = so3_log(quat_mul(quat_conj(kf_quat), res.kf_quat))
    ba_quat = quat_mul(kf_quat, so3_exp(scale * drot))
    ba_quat = ba_quat / _norm(ba_quat, True)
    enough = (obs_w.sum((1, 2)) >= 12) & (state.kf_valid.sum(1) >= 3) & \
        finite & (d_kf <= WILD_M) & ~state.lost

    # write back: keyframes (undo the chronological reorder)
    inv = torch.argsort(order, dim=1)
    gate = enough[:, None, None]
    new_kf_pos = torch.where(gate, _take(ba_pos, inv), state.kf_pos)
    new_kf_quat = torch.where(gate, _take(ba_quat, inv), state.kf_quat)

    # map write-back, gated per point; slot ids may repeat (an unmatched
    # observation carries its nearest slot): the last row wins
    valid_pt = (obs_w.sum(1) >= 2) & (_norm(res.points - pts0) <= 1.0)
    map_xyz = _set_last(state.map_xyz, slots, torch.where(
        (valid_pt & enough[:, None])[..., None], res.points, pts0))
    return state._replace(kf_pos=new_kf_pos, kf_quat=new_kf_quat,
                          map_xyz=map_xyz)
