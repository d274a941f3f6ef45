"""Sliding-window visual-inertial bundle adjustment
(``nclt_slam_tpu/vio/ba.py`` and ``nclt_slam_tpu/ops/ba_pallas.py``).

A batch of B windows, each with K keyframe poses and P landmarks, is
refined by ``iters`` damped Gauss-Newton steps:

- Huber-weighted pixel reprojection + whitened-depth residuals per
  (keyframe, landmark) observation (mask-weighted; shapes never change);
- relative-pose factors between consecutive keyframes, weighted by
  ``w_rel``;
- a prior of weight 1e4 pinning keyframe 0 (gauge freedom);
- an optional per-point prior toward the input estimate.

The landmarks are eliminated by the Schur complement and the reduced
(6K x 6K) camera system is solved densely.  Parameterization: pose k =
(rotation-vector increment about the linearization quaternion,
translation), landmarks as world xyz.  Every Jacobian is written out
analytically: the JAX package takes them with ``jacfwd`` of the same
residuals, to rounding.

``solve_ba`` sends CUDA tensors to the hand-written kernel
(``ops/ba.py``, ``csrc/ba.cu``) and CPU tensors to ``solve_ba_plain``, the
same function in batched PyTorch.  The two differ in the reduced solve
(Gauss-Jordan against Cholesky) and in summation order, so they agree by
tolerance on consistent windows, not bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nclt_slam_tpu_torch.config import CameraConfig, VioConfig
from nclt_slam_tpu_torch.core.quat import (
    quat_conj,
    quat_mul,
    quat_to_mat,
    skew,
    so3_exp,
    so3_log,
)

PRIOR_W = 1e4       # gauge prior on keyframe 0
HUBER_Z = 6.0       # robust cap on the whitened depth (3 sigma, px-equivalent)


class BAProblem(NamedTuple):
    """Fixed-shape BA inputs: B windows of K keyframes and P landmarks."""

    kf_pos: torch.Tensor      # (B, K, 3) initial body positions
    kf_quat: torch.Tensor     # (B, K, 4) initial body orientations (xyzw)
    points: torch.Tensor      # (B, P, 3) initial landmark positions
    obs_uv: torch.Tensor      # (B, K, P, 2) observed pixels
    obs_z: torch.Tensor       # (B, K, P) observed camera-frame depth
    obs_w: torch.Tensor       # (B, K, P) observation weights (0 = unobserved)
    rel_dp: torch.Tensor      # (B, K-1, 3) measured relative translation
    rel_dq: torch.Tensor      # (B, K-1, 4) measured relative rotation
    w_rel: torch.Tensor | float  # relative-factor weight: a scalar, (B,)
    #                              or (B, K-1)
    # optional per-point position prior anchoring each landmark at its input
    # estimate, in the units of one pixel^2 residual; None = free points
    pt_prior_w: torch.Tensor | None = None  # (B, P)


class BAResult(NamedTuple):
    kf_pos: torch.Tensor      # (B, K, 3)
    kf_quat: torch.Tensor     # (B, K, 4)
    points: torch.Tensor      # (B, P, 3)
    final_cost: torch.Tensor  # (B,) cost at the last linearization point


def broadcast_w_rel(w_rel, B: int, Km1: int, device,
                    dtype=torch.float32) -> torch.Tensor:
    """``w_rel`` as a (B, K-1) tensor."""
    w = torch.as_tensor(w_rel, dtype=dtype, device=device)
    if w.dim() == 1:
        w = w[:, None]
    return w.expand(B, Km1)


def _inv3x3(A):
    """Closed-form batched 3x3 inverse via the adjugate, with the
    determinant guarded at 1e-12."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / torch.where(det.abs() > 1e-12, det,
                                torch.full_like(det, 1e-12))
    adj = torch.stack([A11, A12, A13, A21, A22, A23, A31, A32, A33],
                      -1).reshape(A.shape)
    return adj * inv_det[..., None, None]


def reprojection(pos, quat, pts, obs_uv, obs_z, cam: CameraConfig):
    """Residuals and Jacobians of every (keyframe, landmark) pair at the
    current estimate.  pos (..., K, 3), quat (..., K, 4), pts (..., P, 3),
    obs_uv (..., K, P, 2), obs_z (..., K, P).  Returns r (..., K, P, 3) =
    [u - u_obs, v - v_obs, 2 (z - z_obs) / sigma_z], Jp (..., K, P, 3, 6)
    against the pose increment [rotation | translation] and Jl
    (..., K, P, 3, 3) against the landmark.

    With y = R^T (X - pos), p_base = y - t_bc and p_cam = (-p_base_y,
    -p_base_z, p_base_x): d p_base / dθ = [y]x, d p_base / dX = R^T and
    d p_base / dp = -R^T.  The depth clamp z = max(p_cam_z, 0.1) zeroes the
    pinhole's depth derivative where it is active."""
    R = quat_to_mat(quat)                                    # (..., K, 3, 3)
    d = pts[..., None, :, :] - pos[..., :, None, :]          # (..., K, P, 3)
    y = torch.matmul(d, R)                                   # R^T d
    pc0 = -y[..., 1]
    pc1 = -(y[..., 2] - cam.cam_offset_up)
    pc2 = y[..., 0] - cam.cam_offset_fwd
    z = pc2.clamp_min(0.1)
    inv_sigz = 2.0 / (cam.depth_noise_rel_per_m * obs_z * obs_z).clamp_min(0.02)
    r = torch.stack([cam.fx * pc0 / z + cam.cx - obs_uv[..., 0],
                     cam.fy * pc1 / z + cam.cy - obs_uv[..., 1],
                     (pc2 - obs_z) * inv_sigz], -1)

    unclamped = (pc2 >= 0.1).to(pos.dtype)
    a = cam.fx / z
    b = -cam.fx * pc0 / (z * z) * unclamped
    c = cam.fy / z
    e = -cam.fy * pc1 / (z * z) * unclamped
    # rows of d r / d p_base (p_base = (pc2 + t_fwd, -pc0, -pc1 + t_up))
    zero = torch.zeros_like(a)
    D = torch.stack([b, -a, zero,
                     e, zero, -c,
                     inv_sigz, zero, zero], -1).reshape(a.shape + (3, 3))
    Rt = R.transpose(-1, -2)[..., None, :, :]                # (..., K, 1, 3, 3)
    Jl = torch.matmul(D, Rt)
    Jp = torch.cat([torch.matmul(D, skew(y)), -Jl], -1)
    return r, Jp, Jl


def robust_weights(r, obs_w, cfg: VioConfig):
    """Observation weight times the Huber weight of the pixel residual and
    the separate robust cap on the whitened depth."""
    rn = torch.linalg.vector_norm(r[..., :2], dim=-1)
    hub = torch.where(rn <= cfg.huber_px, torch.ones_like(rn),
                      cfg.huber_px / rn.clamp_min(1e-6))
    rz = r[..., 2].abs()
    hub_z = torch.where(rz <= HUBER_Z, torch.ones_like(rz),
                        HUBER_Z / rz.clamp_min(1e-6))
    return obs_w * hub * hub_z


def rel_residual(pos_i, q_i, pos_j, q_j, dp_meas, dq_meas):
    """Relative-pose factor residual (..., 6) between consecutive
    keyframes: [log(dq_meas^-1 q_i^-1 q_j), R_i^T (p_j - p_i) - dp_meas]."""
    dq_est = quat_mul(quat_conj(q_i), q_j)
    dp_est = ((pos_j - pos_i)[..., :, None] * quat_to_mat(q_i)).sum(-2)
    r_rot = so3_log(quat_mul(quat_conj(dq_meas), dq_est))
    return torch.cat([r_rot, dp_est - dp_meas], -1)


def _so3_log_jac(q):
    """d so3_log(q) / dq, (..., 3, 4), of the function as ``core.quat``
    writes it (sign canonicalization, w clamped to [-1, 1], scale 2 below
    |v| = 1e-8)."""
    s = torch.where(q[..., 3:4] < 0, -1.0, 1.0)
    q = q * s
    v = q[..., :3]
    w_in = (q[..., 3].abs() <= 1.0).to(q.dtype)
    w = q[..., 3].clamp(-1.0, 1.0)
    n = torch.sqrt((v * v).sum(-1))
    small = n < 1e-8
    n_safe = torch.where(small, torch.ones_like(n), n)
    n2w2 = torch.where(small, torch.ones_like(n), n * n + w * w)
    angle = 2.0 * torch.atan2(n, w)
    scale = torch.where(small, torch.full_like(n, 2.0), angle / n_safe)
    dscale_dn = torch.where(small, torch.zeros_like(n),
                            (2.0 * w / n2w2 - angle / n_safe) / n_safe)
    dscale_dw = torch.where(small, torch.zeros_like(n), -2.0 / n2w2 * w_in)
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    Jv = scale[..., None, None] * eye + \
        (dscale_dn / n_safe)[..., None, None] * v[..., :, None] * v[..., None, :]
    Jw = (dscale_dw[..., None] * v)[..., None]
    return torch.cat([Jv, Jw], -1) * s[..., None]


def rel_jacobians(pos_i, q_i, pos_j, q_j, dq_meas):
    """Jacobians (..., 6, 6) of ``rel_residual`` against the increments of
    pose i and pose j ([rotation | translation], q <- q exp(dθ),
    p <- p + dp) at zero.

    With m = dq_meas^-1 and c = q_i^-1 q_j the rotation residual is
    log(m c); q_j exp(dθ) turns it into log(m c exp(dθ)) and q_i exp(dθ)
    into log(m exp(-dθ) c), and d exp(dθ) / dθ = [I / 2; 0] at zero."""
    m = quat_conj(dq_meas)
    c = quat_mul(quat_conj(q_i), q_j)
    a = quat_mul(m, c)
    Jlog = _so3_log_jac(a)                                   # (..., 3, 4)
    basis = torch.zeros(3, 4, dtype=q_i.dtype, device=q_i.device)
    basis[0, 0] = basis[1, 1] = basis[2, 2] = 0.5
    # columns k: d a / dθ_k
    Dj = quat_mul(a[..., None, :], basis).transpose(-1, -2)  # (..., 4, 3)
    Di = -quat_mul(quat_mul(m[..., None, :], basis),
                   c[..., None, :]).transpose(-1, -2)
    Rt = quat_to_mat(q_i).transpose(-1, -2)
    y = torch.matmul(Rt, (pos_j - pos_i)[..., None])[..., 0]
    zero = torch.zeros_like(Rt)
    Ji = torch.cat([torch.cat([torch.matmul(Jlog, Di), zero], -1),
                    torch.cat([skew(y), -Rt], -1)], -2)
    Jj = torch.cat([torch.cat([torch.matmul(Jlog, Dj), zero], -1),
                    torch.cat([zero, Rt], -1)], -2)
    return Ji, Jj


def _check(prob: BAProblem, dtypes=(torch.float32,)):
    if prob.kf_pos.dim() != 3 or prob.kf_pos.shape[-1] != 3:
        raise ValueError("solve_ba takes batched windows: kf_pos (B, K, 3); "
                         f"got {tuple(prob.kf_pos.shape)}")
    B, K, _ = prob.kf_pos.shape
    P = prob.points.shape[1]
    want = dict(kf_quat=(B, K, 4), points=(B, P, 3), obs_uv=(B, K, P, 2),
                obs_z=(B, K, P), obs_w=(B, K, P), rel_dp=(B, K - 1, 3),
                rel_dq=(B, K - 1, 4))
    if prob.pt_prior_w is not None:
        want["pt_prior_w"] = (B, P)
    if K < 2:
        raise ValueError("solve_ba needs at least two keyframes")
    tensors = [prob.kf_pos]
    for name, shape in want.items():
        t = getattr(prob, name)
        if tuple(t.shape) != shape:
            raise ValueError(f"solve_ba: {name} is {tuple(t.shape)}, "
                             f"expected {shape}")
        tensors.append(t)
    if prob.kf_pos.dtype not in dtypes or \
            any(t.dtype != prob.kf_pos.dtype for t in tensors):
        raise TypeError("solve_ba takes tensors of one dtype out of "
                        f"{[str(d) for d in dtypes]}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("solve_ba inputs are on different devices")


def solve_ba_plain(prob: BAProblem, cam: CameraConfig, cfg: VioConfig,
                   iters: int | None = None) -> BAResult:
    """The plain PyTorch version: batched einsums and a Cholesky solve of
    the reduced system.  A window whose system is not positive definite (or
    not finite) takes a zero pose step, and nothing of it reaches another
    window.  It also takes float64 problems: a reference to hold the
    float32 solvers against."""
    _check(prob, (torch.float32, torch.float64))
    B, K, _ = prob.kf_pos.shape
    P = prob.points.shape[1]
    N = 6 * K
    dev, dt = prob.kf_pos.device, prob.kf_pos.dtype
    n_iter = iters or cfg.gn_iters
    damping = cfg.lm_damping
    w_rel = broadcast_w_rel(prob.w_rel, B, K - 1, dev, dt)   # (B, K-1)
    eye3 = torch.eye(3, device=dev, dtype=dt)
    eyeN = torch.eye(N, device=dev, dtype=dt)
    kk = torch.arange(K, device=dev)
    ii = kk[:-1]

    pos, quat, pts = prob.kf_pos, prob.kf_quat, prob.points
    cost = torch.zeros(B, device=dev, dtype=dt)
    for _ in range(n_iter):
        r, Jp, Jl = reprojection(pos, quat, pts, prob.obs_uv, prob.obs_z, cam)
        w = robust_weights(r, prob.obs_w, cfg)               # (B, K, P)
        Jpw = Jp * w[..., None, None]
        Jlw = Jl * w[..., None, None]
        H_pp = torch.einsum("bkpri,bkprj->bkij", Jpw, Jp)    # (B, K, 6, 6)
        H_ll = torch.einsum("bkpri,bkprj->bpij", Jlw, Jl)    # (B, P, 3, 3)
        H_pl = torch.einsum("bkpri,bkprj->bkpij", Jpw, Jl)   # (B, K, P, 6, 3)
        g_p = torch.einsum("bkpri,bkpr->bki", Jpw, r)        # (B, K, 6)
        g_l = torch.einsum("bkpri,bkpr->bpi", Jlw, r)        # (B, P, 3)

        # relative-pose factors -> block-tridiagonal pose terms
        args = (pos[:, :-1], quat[:, :-1], pos[:, 1:], quat[:, 1:])
        r_rel = rel_residual(*args, prob.rel_dp, prob.rel_dq)  # (B, K-1, 6)
        Ji, Jj = rel_jacobians(*args, prob.rel_dq)           # (B, K-1, 6, 6)
        wJi = w_rel[..., None, None] * Ji
        wJj = w_rel[..., None, None] * Jj
        Hb = torch.zeros(B, K, K, 6, 6, device=dev, dtype=dt)
        Hb[:, kk, kk] += H_pp
        Hb[:, ii, ii] += torch.einsum("bkri,bkrj->bkij", wJi, Ji)
        Hb[:, ii + 1, ii + 1] += torch.einsum("bkri,bkrj->bkij", wJj, Jj)
        Hb[:, ii, ii + 1] += torch.einsum("bkri,bkrj->bkij", wJi, Jj)
        Hb[:, ii + 1, ii] += torch.einsum("bkri,bkrj->bkij", wJj, Ji)
        g = g_p.clone()
        g[:, :-1] += torch.einsum("bkri,bkr->bki", wJi, r_rel)
        g[:, 1:] += torch.einsum("bkri,bkr->bki", wJj, r_rel)
        Hb[:, 0, 0] += PRIOR_W * torch.eye(6, device=dev, dtype=dt)
        H = Hb.permute(0, 1, 3, 2, 4).reshape(B, N, N)
        g = g.reshape(B, N)

        if prob.pt_prior_w is not None:
            H_ll = H_ll + prob.pt_prior_w[..., None, None] * eye3
            g_l = g_l + prob.pt_prior_w[..., None] * (pts - prob.points)

        # Schur complement over the landmarks
        H_ll_inv = _inv3x3(H_ll + damping * eye3)            # (B, P, 3, 3)
        Bm = H_pl.permute(0, 2, 1, 3, 4).reshape(B, P, N, 3)
        C = torch.matmul(Bm, H_ll_inv)                       # (B, P, N, 3)
        S_corr = torch.einsum("bpaj,bpcj->bac", C, Bm)
        g_corr = torch.einsum("bpaj,bpj->ba", C, g_l)
        S = H - S_corr + damping * eyeN
        rhs = -(g - g_corr)
        L, info = torch.linalg.cholesky_ex(S)
        delta_p = torch.cholesky_solve(rhs[..., None], L)[..., 0]
        delta_p = torch.where((info == 0)[:, None], delta_p,
                              torch.zeros_like(delta_p))
        delta_p = torch.nan_to_num(delta_p, nan=0.0, posinf=0.0, neginf=0.0)

        # back-substitute the landmarks
        Bt_dp = torch.einsum("bpai,ba->bpi", Bm, delta_p)
        delta_l = -torch.matmul(H_ll_inv, (g_l + Bt_dp)[..., None])[..., 0]

        cost = (w * (r * r).sum(-1)).sum((1, 2)) + \
            (w_rel[..., None] * r_rel * r_rel).sum((1, 2))
        dposes = delta_p.reshape(B, K, 6)
        pos = pos + dposes[..., 3:]
        quat = quat_mul(quat, so3_exp(dposes[..., :3]))
        quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
        pts = pts + delta_l
    return BAResult(kf_pos=pos, kf_quat=quat, points=pts, final_cost=cost)


def solve_ba(prob: BAProblem, cam: CameraConfig, cfg: VioConfig,
             iters: int | None = None, site: str = "other") -> BAResult:
    """``iters`` (default ``cfg.gn_iters``) damped Gauss-Newton steps on a
    batch of windows.  CUDA tensors go through the hand-written kernel (one
    block per window); CPU tensors through ``solve_ba_plain``.  ``site``
    names the caller in the kernel's launch counts."""
    _check(prob)
    dev = prob.kf_pos.device
    if dev.type == "cpu":
        return solve_ba_plain(prob, cam, cfg, iters)
    from nclt_slam_tpu_torch.ops.ba import solve_ba_cuda
    return solve_ba_cuda(prob, cam, cfg, iters, site=site)
