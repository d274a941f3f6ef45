"""The v55 pose-fusion relay (``nclt_slam_tpu/fusion/relay.py``).

Encoder + compass dead-reckoning from GT differences, the one-time
SE(3)->SE(2) SLAM alignment over a 50-sample averaged window (with GT-motion
restart and yaw-jitter gate), SLAM freeze detection, four fusion regimes
(strong / ok / no_anchor adaptive alpha / encoder fallback) and jump
rejection; yaw from the encoder compass.  Every tensor carries a leading
route dimension; the JAX package's whole-state ``tree_map(where)`` masks
are per-route ``torch.where`` over every field.

Regime codes in the trace: 0 no_anchor, 1 ok, 2 strong, 3 encoder-fallback.
The 4x4 inverses are closed-form rigid inverses (no host synchronisation,
no LU): the SLAM poses are rotations from ``quat_to_mat``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nclt_slam_tpu_torch.config import EncoderConfig, FusionConfig
from nclt_slam_tpu_torch.core import prng
from nclt_slam_tpu_torch.core.lie import se3_inverse, wrap_angle
from nclt_slam_tpu_torch.core.quat import quat_to_mat

# OpenCV camera (x right, y down, z fwd) -> FLU nav frame (v55.py:361-366)
T_FLU_FROM_CAM = ((0.0, 0.0, 1.0, 0.0),
                  (-1.0, 0.0, 0.0, 0.0),
                  (0.0, -1.0, 0.0, 0.0),
                  (0.0, 0.0, 0.0, 1.0))

ALIGN_FIELDS = 10  # sx sy sz qx qy qz qw gt_x gt_y gt_yaw

REGIME_NO_ANCHOR = 0
REGIME_OK = 1
REGIME_STRONG = 2
REGIME_ENCODER = 3


class FusionState(NamedTuple):
    enc_xy: torch.Tensor          # (B, 2)
    enc_yaw: torch.Tensor
    enc_total_dist: torch.Tensor
    prev_gt_xy: torch.Tensor      # (B, 2)
    initialized: torch.Tensor     # bool
    T_nav_slam: torch.Tensor      # (B, 4, 4)
    committed: torch.Tensor       # bool
    align_buf: torch.Tensor       # (B, align_window, ALIGN_FIELDS)
    align_n: torch.Tensor         # int32
    align_gt0: torch.Tensor       # (B, 2)
    align_gt0_set: torch.Tensor   # bool
    prev_slam_xz: torch.Tensor    # (B, 2)
    have_prev_slam: torch.Tensor  # bool
    frozen_count: torch.Tensor    # int32
    anchor_xy: torch.Tensor       # (B, 2)
    anchor_std: torch.Tensor
    anchor_tick: torch.Tensor     # int32
    has_anchor: torch.Tensor      # bool
    strong_streak: torch.Tensor   # int32
    prev_nav: torch.Tensor        # (B, 3)
    have_prev_nav: torch.Tensor   # bool
    pub_nav: torch.Tensor         # (B, 3)
    compass_bias: torch.Tensor    # (B,)


def init_fusion(cfg: FusionConfig, batch: int, device) -> FusionState:
    B = batch
    z = dict(device=device)
    f = torch.zeros(B, **z)
    zb = torch.zeros(B, dtype=torch.bool, **z)
    zi = torch.zeros(B, dtype=torch.int32, **z)
    return FusionState(
        enc_xy=torch.zeros(B, 2, **z), enc_yaw=f, enc_total_dist=f.clone(),
        prev_gt_xy=torch.zeros(B, 2, **z), initialized=zb,
        T_nav_slam=torch.eye(4, **z).expand(B, 4, 4).clone(),
        committed=zb.clone(),
        align_buf=torch.zeros(B, cfg.align_window, ALIGN_FIELDS, **z),
        align_n=zi, align_gt0=torch.zeros(B, 2, **z),
        align_gt0_set=zb.clone(),
        prev_slam_xz=torch.zeros(B, 2, **z), have_prev_slam=zb.clone(),
        frozen_count=zi.clone(),
        anchor_xy=torch.zeros(B, 2, **z), anchor_std=f + 999.0,
        anchor_tick=zi - 10 ** 6, has_anchor=zb.clone(),
        strong_streak=zi.clone(),
        prev_nav=torch.zeros(B, 3, **z), have_prev_nav=zb.clone(),
        pub_nav=torch.zeros(B, 3, **z),
        compass_bias=f.clone(),
    )


def _flu_from_cam(device):
    return torch.tensor(T_FLU_FROM_CAM, device=device)


def select_routes(mask, new, old):
    """Per-route select over every field of two states (the JAX package's
    ``tree_map(lambda n, o: jnp.where(mask, n, o), new, old)``)."""
    def sel(n, o):
        m = mask.reshape(mask.shape + (1,) * (n.dim() - 1))
        return torch.where(m, n, o)
    return type(new)(*(sel(n, o) for n, o in zip(new, old)))


def anchor_update(state: FusionState, anchor_xy, anchor_std, tick: int,
                  cfg: FusionConfig) -> FusionState:
    """Ingest an /anchor_correction message (v55 _anchor_cb) for every
    route; the caller masks the routes that published none."""
    streak = torch.where(anchor_std <= cfg.anchor_strong_std,
                         state.strong_streak + 1,
                         (state.strong_streak - 1).clamp_min(0))
    enc_xy = state.enc_xy + cfg.anchor_enc_feedback * \
        (anchor_xy - state.enc_xy)
    return state._replace(
        anchor_xy=anchor_xy, anchor_std=anchor_std,
        anchor_tick=torch.full_like(state.anchor_tick, tick),
        has_anchor=torch.ones_like(state.has_anchor),
        strong_streak=streak.to(state.strong_streak.dtype), enc_xy=enc_xy)


def _nav_origin(x, y, yaw):
    """(B, 4, 4) planar pose at (x, y) with heading yaw."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([c, -s, z, x, s, c, z, y, z, z, o, z, z, z, z, o],
                       -1).reshape(c.shape + (4, 4))


def _se3(R, t):
    return torch.cat([torch.cat([R, t[..., None]], -1),
                      torch.tensor([0.0, 0.0, 0.0, 1.0], device=R.device)
                      .expand(R.shape[:-2] + (1, 4))], -2)


def _tick_alignment(T_slam, gt_x, gt_y, gt_yaw):
    """Naive single-sample alignment used while buffering (:382-399)."""
    T = _nav_origin(gt_x, gt_y, gt_yaw) @ _flu_from_cam(T_slam.device) @ \
        se3_inverse(T_slam)
    T_nav = T @ T_slam
    return T_nav[:, 0, 3], T_nav[:, 1, 3], gt_yaw


def _slam_to_nav(state: FusionState, T_slam, slam_quat, slam_t, gt_x, gt_y,
                 gt_yaw, cfg: FusionConfig):
    """SE(3)->SE(2) with the one-time averaged alignment window."""
    W = cfg.align_window
    dev = T_slam.device
    gt = torch.stack([gt_x, gt_y], -1)

    # GT displacement since buffering started -> restart if the robot moved
    gt0 = torch.where(state.align_gt0_set[:, None], state.align_gt0, gt)
    moved = torch.linalg.vector_norm(gt - gt0, dim=-1) > cfg.align_max_gt_disp

    sample = torch.cat([slam_t, slam_quat, gt, gt_yaw[:, None]], -1)
    n = torch.where(moved, torch.zeros_like(state.align_n), state.align_n)
    buf = torch.where(moved[:, None, None], torch.zeros_like(state.align_buf),
                      state.align_buf)
    idx = torch.arange(W, device=dev)
    buf = torch.where((idx == n.clamp_max(W - 1)[:, None])[..., None],
                      sample[:, None], buf)
    n = (n + 1).clamp_max(W)
    full = n >= W

    # averaged alignment from the buffer
    valid = (idx < n[:, None])[..., None]                  # (B, W, 1)
    cnt = n.clamp_min(1).to(torch.float32)[:, None]        # (B, 1)
    avg_t = (buf[..., 0:3] * valid).sum(1) / cnt
    quats = buf[..., 3:7]
    dots = (quats * buf[:, :1, 3:7]).sum(-1)
    aligned = torch.where((dots < 0)[..., None], -quats, quats) * valid
    avg_q = aligned.sum(1) / cnt
    avg_q = avg_q / (torch.linalg.vector_norm(avg_q, dim=-1,
                                              keepdim=True) + 1e-9)
    v0 = valid[..., 0]
    avg_gt_x = (buf[..., 7] * v0).sum(1) / cnt[:, 0]
    avg_gt_y = (buf[..., 8] * v0).sum(1) / cnt[:, 0]
    yaws = buf[..., 9]
    sin_m = (torch.sin(yaws) * v0).sum(1) / cnt[:, 0]
    cos_m = (torch.cos(yaws) * v0).sum(1) / cnt[:, 0]
    avg_yaw = torch.atan2(sin_m, cos_m)
    yaw_res = wrap_angle(yaws - avg_yaw[:, None]) * v0
    yaw_std_deg = torch.rad2deg(torch.sqrt((yaw_res ** 2).sum(1) / cnt[:, 0]))
    jittery = yaw_std_deg > cfg.align_max_yaw_std_deg

    # jittery full window -> drop the oldest half and keep buffering
    half = W // 2
    drop = full & jittery
    buf = torch.where(drop[:, None, None], torch.roll(buf, -half, 1), buf)
    n = torch.where(drop, torch.full_like(n, W - half), n)

    # commit the averaged alignment
    T_slam_avg = _se3(quat_to_mat(avg_q), avg_t)
    T_commit = _nav_origin(avg_gt_x, avg_gt_y, avg_yaw) @ \
        _flu_from_cam(dev) @ se3_inverse(T_slam_avg)
    commit_now = full & ~jittery & ~state.committed
    T_nav_slam = torch.where(commit_now[:, None, None], T_commit,
                             state.T_nav_slam)
    committed = state.committed | commit_now

    c_ = state.committed
    new_state = state._replace(
        T_nav_slam=T_nav_slam, committed=committed,
        align_buf=torch.where(c_[:, None, None], state.align_buf, buf),
        align_n=torch.where(c_, state.align_n, n),
        align_gt0=torch.where(c_[:, None], state.align_gt0,
                              torch.where(moved[:, None], gt, gt0)),
        align_gt0_set=state.align_gt0_set | ~c_)

    # output: committed transform if available, else per-tick fallback;
    # right-multiplying by the inverse convention rotation makes the body
    # frame FLU again
    T_nav = T_nav_slam @ T_slam @ _flu_from_cam(dev).transpose(-1, -2)
    nav_c = (T_nav[:, 0, 3], T_nav[:, 1, 3],
             torch.atan2(T_nav[:, 1, 0], T_nav[:, 0, 0]))
    fx, fy, fyaw = _tick_alignment(T_slam, gt_x, gt_y, gt_yaw)
    nav_x = torch.where(committed, nav_c[0], fx)
    nav_y = torch.where(committed, nav_c[1], fy)
    nav_yaw = torch.where(committed, nav_c[2], fyaw)
    return new_state, nav_x, nav_y, nav_yaw


def fusion_tick(state: FusionState, gt_x, gt_y, gt_yaw, slam_t, slam_quat,
                slam_ok, tick: int, key, enc_cfg: EncoderConfig,
                cfg: FusionConfig):
    """One relay tick for every route (gt_* (B,), slam_t (B, 3), slam_quat
    (B, 4), slam_ok (B,), key (B, 2)).  Returns (state, nav_x, nav_y,
    nav_yaw, regime)."""
    k1, k2, k3 = prng.split(key, 3).unbind(-2)
    gt = torch.stack([gt_x, gt_y], -1)

    # ---- encoder+compass dead-reckoning (always running fallback) ----
    first = ~state.initialized
    compass_bias = state.compass_bias + enc_cfg.compass_drift * 0.1 * \
        prng.normal(k3)
    noisy_yaw = gt_yaw + compass_bias + enc_cfg.compass_noise * \
        prng.normal(k1)
    d = gt - state.prev_gt_xy
    displacement = torch.linalg.vector_norm(d, dim=-1)
    if enc_cfg.signed_disp:
        base_disp = d[:, 0] * torch.cos(gt_yaw) + d[:, 1] * torch.sin(gt_yaw)
    else:
        base_disp = displacement
    noisy_disp = base_disp * (1.0 + enc_cfg.dist_noise * prng.normal(k2))
    move = ~first & (displacement > 0.001)
    step = noisy_disp[:, None] * torch.stack([torch.cos(noisy_yaw),
                                              torch.sin(noisy_yaw)], -1)
    enc_xy = torch.where(first[:, None], gt, state.enc_xy + torch.where(
        move[:, None], step, torch.zeros_like(step)))
    enc_yaw = torch.where(first, gt_yaw, noisy_yaw)
    enc_total = state.enc_total_dist + torch.where(
        move, displacement, torch.zeros_like(displacement))
    state = state._replace(
        enc_xy=enc_xy, enc_yaw=enc_yaw, enc_total_dist=enc_total,
        prev_gt_xy=gt, initialized=torch.ones_like(state.initialized),
        compass_bias=compass_bias)

    # ---- freeze detection (camera xz plane) ----
    slam_xz = torch.stack([slam_t[:, 0], slam_t[:, 2]], -1)
    slam_motion = torch.linalg.vector_norm(slam_xz - state.prev_slam_xz,
                                           dim=-1)
    frozen_inc = state.have_prev_slam & \
        (displacement > cfg.freeze_enc_min_disp) & \
        (slam_motion < cfg.freeze_slam_max_motion)
    frozen_count = torch.where(
        slam_ok, torch.where(frozen_inc, state.frozen_count + 1,
                             torch.zeros_like(state.frozen_count)),
        state.frozen_count)
    state = state._replace(
        prev_slam_xz=torch.where(slam_ok[:, None], slam_xz,
                                 state.prev_slam_xz),
        have_prev_slam=state.have_prev_slam | slam_ok,
        frozen_count=frozen_count)
    slam_ok = slam_ok & (frozen_count <= cfg.freeze_ticks)

    # ---- SE(3)->SE(2) alignment, advanced only while SLAM is tracking ----
    T_slam = _se3(quat_to_mat(slam_quat), slam_t)
    align_state, slam_nx, slam_ny, slam_nyaw = _slam_to_nav(
        state, T_slam, slam_quat, slam_t, gt_x, gt_y, gt_yaw, cfg)
    state = select_routes(slam_ok, align_state, state)

    # ---- regime selection + blend ----
    tick_f = torch.full((), float(tick), device=gt.device) * 0.1
    anchor_age = tick_f - state.anchor_tick.to(torch.float32) * 0.1
    anchor_fresh = state.has_anchor & (anchor_age <= cfg.anchor_stale_s) & \
        (state.anchor_std <= cfg.anchor_ok_std)
    anchor_strong = anchor_fresh & \
        (state.anchor_std <= cfg.anchor_strong_std) & \
        (state.strong_streak >= cfg.anchor_hysteresis_n)
    i32 = torch.int32

    def code(v):
        return torch.full_like(state.frozen_count, v, dtype=i32)

    regime = torch.where(anchor_strong, code(REGIME_STRONG),
                         torch.where(anchor_fresh, code(REGIME_OK),
                                     code(REGIME_NO_ANCHOR)))
    ax, ay = state.anchor_xy[:, 0], state.anchor_xy[:, 1]
    ex, ey = state.enc_xy[:, 0], state.enc_xy[:, 1]
    strong_x = cfg.strong_w_anchor * ax + cfg.strong_w_slam * slam_nx + \
        cfg.strong_w_enc * ex
    strong_y = cfg.strong_w_anchor * ay + cfg.strong_w_slam * slam_ny + \
        cfg.strong_w_enc * ey
    ok_x = cfg.ok_w_anchor * ax + cfg.ok_w_slam * slam_nx + cfg.ok_w_enc * ex
    ok_y = cfg.ok_w_anchor * ay + cfg.ok_w_slam * slam_ny + cfg.ok_w_enc * ey

    # adaptive no-anchor alpha (exp 54 ladder)
    slam_enc_d = torch.hypot(slam_nx - ex, slam_ny - ey)
    a0, a1, a2, a3 = cfg.noanchor_alpha_steps
    d0, d1, d2 = cfg.noanchor_dist_steps
    f = torch.full_like
    alpha_ladder = torch.where(
        slam_enc_d < d0, f(ex, a0), torch.where(
            slam_enc_d < d1, f(ex, a1), torch.where(
                slam_enc_d < d2, f(ex, a2), f(ex, a3))))
    anchor_recent = state.has_anchor & \
        (anchor_age <= cfg.noanchor_anchor_age_s)
    alpha = torch.where(anchor_recent, f(ex, a0), alpha_ladder)
    na_x = alpha * slam_nx + (1.0 - alpha) * ex
    na_y = alpha * slam_ny + (1.0 - alpha) * ey

    nav_x = torch.where(regime == REGIME_STRONG, strong_x,
                        torch.where(regime == REGIME_OK, ok_x, na_x))
    nav_y = torch.where(regime == REGIME_STRONG, strong_y,
                        torch.where(regime == REGIME_OK, ok_y, na_y))

    # encoder fallback when SLAM lost/stale/frozen
    nav_x = torch.where(slam_ok, nav_x, ex)
    nav_y = torch.where(slam_ok, nav_y, ey)
    regime = torch.where(slam_ok, regime, code(REGIME_ENCODER))
    if cfg.fuse_slam_yaw:
        nav_yaw = torch.where(slam_ok & state.committed, slam_nyaw, enc_yaw)
    else:
        nav_yaw = enc_yaw

    # ---- jump rejection on the raw aligned-SLAM pose delta ----
    gate = state.have_prev_nav & slam_ok & state.committed
    pos_jump = gate & (torch.hypot(slam_nx - state.prev_nav[:, 0],
                                   slam_ny - state.prev_nav[:, 1])
                       > cfg.jump_threshold_m)
    yaw_jump = gate & (wrap_angle(slam_nyaw - state.prev_nav[:, 2]).abs()
                       > cfg.yaw_jump_threshold)
    nav_x = torch.where(pos_jump, ex, nav_x)
    nav_y = torch.where(pos_jump, ey, nav_y)
    if cfg.fuse_slam_yaw:
        nav_yaw = torch.where(yaw_jump, enc_yaw, nav_yaw)

    track = slam_ok & state.committed
    state = state._replace(
        prev_nav=torch.where(track[:, None],
                             torch.stack([slam_nx, slam_ny, slam_nyaw], -1),
                             state.prev_nav),
        have_prev_nav=state.have_prev_nav | track,
        pub_nav=torch.stack([nav_x, nav_y, nav_yaw], -1))
    return state, nav_x, nav_y, nav_yaw, regime
