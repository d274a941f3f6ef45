"""Synthetic Phidgets-1042 IMU (``nclt_slam_tpu/sensors/imu.py``).

Body rates from quaternion differencing with a 0.4/0.6 low-pass, specific
force from double-differentiated position with an 11-tap mean filter,
gravity rotated into the body frame, white noise + constant per-run biases,
and the standstill gate (< 15 mm over a 100 ms window -> pure gravity).
Every tensor carries a leading route dimension.

``imu_block`` runs one nav tick's 20 substeps.  What does not depend on the
IMU state — velocities, raw accelerations, quaternion-difference rates, the
gravity-only specific force and all 20 x 2 noise draws — is computed for
the whole block at once; only the low-pass, the accel ring buffer and the
position ring stay a per-substep loop.  The noise bits equal the JAX
package's per-step ``split``/``normal`` draws.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from refsim.config import ImuConfig
from refsim.core import prng
from refsim.core.quat import quat_conj, quat_mul, quat_rotate, so3_log


class ImuState(NamedTuple):
    prev_pos: torch.Tensor       # (B, 3)
    prev_vel: torch.Tensor       # (B, 3) world velocity
    prev_quat: torch.Tensor      # (B, 4)
    prev_omega: torch.Tensor     # (B, 3) filtered body rate
    accel_buf: torch.Tensor      # (B, taps, 3) raw world-accel ring buffer
    accel_n: torch.Tensor        # (B,) int32 — samples in ring so far
    pos_hist: torch.Tensor       # (B, window, 3) position history ring
    pos_n: torch.Tensor          # (B,) int32
    bias_gyro: torch.Tensor      # (B, 3) constant per-run bias
    bias_accel: torch.Tensor     # (B, 3)
    initialized: torch.Tensor    # (B,) bool


def init_imu(key, cfg: ImuConfig) -> ImuState:
    """key (B, 2)."""
    B = key.shape[0]
    dev = key.device
    kg, ka = prng.split(key).unbind(1)
    quat = torch.zeros(B, 4, device=dev)
    quat[:, 3] = 1.0
    zi = torch.zeros(B, dtype=torch.int32, device=dev)
    return ImuState(
        prev_pos=torch.zeros(B, 3, device=dev),
        prev_vel=torch.zeros(B, 3, device=dev),
        prev_quat=quat,
        prev_omega=torch.zeros(B, 3, device=dev),
        accel_buf=torch.zeros(B, cfg.accel_mean_taps, 3, device=dev),
        accel_n=zi,
        pos_hist=torch.zeros(B, cfg.standstill_window, 3, device=dev),
        pos_n=zi.clone(),
        bias_gyro=cfg.gyro_bias_std * prng.normal(kg, (3,)),
        bias_accel=cfg.accel_bias_std * prng.normal(ka, (3,)),
        initialized=torch.zeros(B, dtype=torch.bool, device=dev),
    )


def _onehot(slot, n: int):
    """(B,) slot -> (B, n, 1) bool mask of that slot."""
    return (torch.arange(n, device=slot.device) == slot[:, None])[..., None]


def imu_block(state: ImuState, positions, quats, dt, key, cfg: ImuConfig):
    """Scan the IMU over one nav tick's substep trajectory.

    positions (B, S, 3), quats (B, S, 4), key (B, 2) -> (new_state,
    measurements (B, S, 6) = [accel | gyro] in the body frame)."""
    B, S, _ = positions.shape
    dev = positions.device
    g_vec = torch.tensor([0.0, 0.0, cfg.gravity], device=dev)
    first0 = ~state.initialized                            # only step 0

    # --- everything that does not depend on the recurrences ---
    prev_pos = torch.cat([state.prev_pos[:, None], positions[:, :-1]], 1)
    prev_q = torch.cat([state.prev_quat[:, None], quats[:, :-1]], 1)
    vel = (positions - prev_pos) / dt                      # (B, S, 3)
    vel0 = torch.where(first0[:, None], torch.zeros_like(vel[:, 0]),
                       vel[:, 0])
    prev_vel = torch.cat([state.prev_vel[:, None], vel0[:, None],
                          vel[:, 1:-1]], 1)[:, :S]
    raw_accel = (vel - prev_vel) / dt
    omega_raw = so3_log(quat_mul(quat_conj(prev_q), quats)) / dt
    q_inv = quat_conj(quats)
    accel_still = quat_rotate(q_inv, g_vec.expand(B, S, 3))
    keys = prng.split(prng.split(key, S), 2)               # (B, S, 2, 2)
    noise = prng.normal(keys, (3,))                        # (B, S, 2, 3)

    # --- the recurrences: low-pass, accel ring, position ring ---
    a_new = cfg.omega_lpf_new
    taps, win = cfg.accel_mean_taps, cfg.standstill_window
    omega_prev, buf, acc_n = state.prev_omega, state.accel_buf, state.accel_n
    pos_hist, pos_n = state.pos_hist, state.pos_n
    omegas, smooth, still = [], [], []
    for k in range(S):
        omega = a_new * omega_raw[:, k] + (1.0 - a_new) * omega_prev
        new_buf = torch.where(_onehot(acc_n % taps, taps),
                              raw_accel[:, k, None], buf)
        n_valid = torch.clamp_max(acc_n + 1, taps)
        smooth.append(new_buf.sum(1) / n_valid.to(torch.float32)[:, None])
        pos_hist = torch.where(_onehot(pos_n % win, win),
                               positions[:, k, None], pos_hist)
        oldest = torch.gather(pos_hist, 1, ((pos_n + 1) % win).long()[
            :, None, None].expand(B, 1, 3))
        max_disp = torch.sqrt(((pos_hist - oldest) ** 2).sum(-1)).amax(1)
        still.append((pos_n + 1 >= win) & (max_disp < cfg.standstill_thresh))
        omegas.append(omega)
        if k == 0:
            omega_prev = torch.where(first0[:, None],
                                     torch.zeros_like(omega), omega)
            buf = torch.where(first0[:, None, None], buf, new_buf)
            acc_n = torch.where(first0, torch.zeros_like(acc_n), acc_n + 1)
        else:
            omega_prev, buf, acc_n = omega, new_buf, acc_n + 1
        pos_n = pos_n + 1

    smooth = torch.stack(smooth, 1)
    accel_moving = quat_rotate(q_inv, smooth + g_vec)
    accel_body = torch.where(torch.stack(still, 1)[..., None], accel_still,
                             accel_moving)
    accel = accel_body + cfg.accel_std * noise[:, :, 0] + \
        state.bias_accel[:, None]
    gyro = torch.stack(omegas, 1) + cfg.gyro_std * noise[:, :, 1] + \
        state.bias_gyro[:, None]
    # first sample after init: pure gravity on z, zero rates
    f = first0[:, None]
    accel[:, 0] = torch.where(f, g_vec.expand(B, 3), accel[:, 0])
    gyro[:, 0] = torch.where(f, torch.zeros_like(gyro[:, 0]), gyro[:, 0])

    new_state = ImuState(
        prev_pos=positions[:, -1], prev_vel=vel0 if S == 1 else vel[:, -1],
        prev_quat=quats[:, -1], prev_omega=omega_prev, accel_buf=buf,
        accel_n=acc_n, pos_hist=pos_hist, pos_n=pos_n,
        bias_gyro=state.bias_gyro, bias_accel=state.bias_accel,
        initialized=torch.ones_like(state.initialized))
    return new_state, torch.cat([accel, gyro], -1)
