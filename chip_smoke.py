#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``nclt_slam_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. print the card (``nvidia-smi`` name and power limit), torch/CUDA versions
   and the TF32 switches;
2. build the three hand-written kernels from ``nclt_slam_tpu_torch/csrc``
   with nvcc, one compiler process per source, all started together;
3. hold the wavefront kernel (K2) against its plain PyTorch version, bit for
   bit (``torch.equal``), at the planner's two shapes — (15, 192, 192)
   windows and the (15, 119, 232) coarse map, 384 iterations, random lethal
   cells — and time both with CUDA events;
4. hold the Hamming cross-check kernel (K1) against its plain version, bit
   for bit on all three outputs, at the main path's shapes — 15 problems of
   256 live features x 384 VIO map points, 75 problems of 256 x 256, and
   the matcher's grouped form (75 stored-feature sets, five per route,
   against their route's 15 live frames) — with ~20 % invalid rows, shared
   rows (ties) and one all-invalid problem, and time both;
5. hold the bundle-adjustment kernel (K3) against its plain version on
   consistent windows (observations are projections of true points, so both
   solvers reach one optimum) by tolerance, at four shapes up to the
   rollout's 15 windows x 16 keyframes x 192 landmarks x 3 iterations; both
   must reach the generator's truth; time it at the rollout's shape and, on
   the batch benchmark's random windows, at 64 x 16 x 192 x 8 iterations
   and the benchmark's sweep shapes;
6. replay the JAX reference fixture of the GT-localized campaign
   (``tests/data/torch_gt_campaign_fixture.npz``: 2 routes at full width,
   100 teach + 100 repeat ticks) and compare within the tolerances below;
7. replay the JAX reference fixture of the ours campaign
   (``tests/data/torch_ours_campaign_fixture.npz``: 2 routes at full width,
   150 VIO-teach + 150 full-stack repeat ticks) and compare;
8. replay the JAX reference fixture of the ``rgbd_ba`` repeat
   (``tests/data/torch_rgbd_ba_campaign_fixture.npz``: 150 ticks off the
   same teach, VIO without the inertial term, the GT-stall watchdog, local
   BA every tenth tick) and compare, the refined keyframe ring and VIO map
   included; every window that the rollout gives K3 is also held against a
   float64 solve, and the replay's end against a replay with the plain
   version in the kernel's place;
9. drive the GT-localized main path through the campaign API: 15 routes at
   full width, a GT teach, teach waypoints, a GT repeat with
   ``stop_when_done=False``; check that K2 was launched on it;
10. drive the ours main path through the campaign API: the 15-route
   campaign at full width, a VIO teach (``config.gt_localization()``), the
   aligned-VIO teach waypoints and a full-stack repeat (``config.ours()``:
   VIO + anchors + v55 fusion) with ``stop_when_done=False``; check that K1
   was launched at both call sites (VIO frame, anchor matcher) and K2 too,
   every trace is finite, every relay committed, an anchor was published
   and the robots moved;
11. drive the bundle-adjustment main path off the same teach, waypoints and
    landmark stores: a 15-route ``baselines.configs.rgbd_ba()`` repeat at
    full width; check that K3 was launched once every tenth tick from
    ``local_ba``, that K1 and K2 were launched, that at least one solve
    passed its gate and moved a keyframe or a map point, every trace is
    finite, every relay committed and the robots moved; then a shorter
    ``rgbd_no_imu()`` repeat (no BA) for the same mode without it;
12. profile a short window of the ours repeat for the launches per tick and
    the device's busy share (last, because the profiler slows every launch
    that follows it in the process).

Each main path runs with the kernels' launch counts set to 0 just before
it and read just after.  The last three lines are a JSON line of
per-kernel results, the card line, and ``{"ok": true, "device": {...}}``.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
FIXTURE = REPO / "tests" / "data" / "torch_gt_campaign_fixture.npz"
OURS_FIXTURE = REPO / "tests" / "data" / "torch_ours_campaign_fixture.npz"
RGBD_BA_FIXTURE = REPO / "tests" / "data" / \
    "torch_rgbd_ba_campaign_fixture.npz"

TEACH_TICKS = 500
REPEAT_TICKS = 300
OURS_TEACH_TICKS = 500
OURS_REPEAT_TICKS = 300
RGBD_BA_REPEAT_TICKS = 300
RGBD_REPEAT_TICKS = 100
BA_PERIOD = 10                        # local BA runs at tick % 10 == 3
PROFILE_TICKS = 10
KERNEL_SHAPES = ((15, 192, 192), (15, 119, 232))
KERNEL_ITERS = 384
# K1 problems: (a-sets, A rows, b-sets, B rows), 8 words (256 bits) a row
HAMMING_SHAPES = ((15, 256, 15, 384), (75, 256, 75, 256), (75, 256, 15, 256))
DESC_WORDS = 8
# K3 against its plain version on consistent windows: (windows, keyframes,
# landmarks, iterations, point prior weight or None, w_rel); the last is
# the rollout's call (one window a route, scalar w_rel, point prior)
BA_SHAPES = ((3, 6, 64, 10, None, 100.0), (1, 6, 40, 6, 50.0, 100.0),
             (2, 10, 48, 6, None, 100.0), (15, 16, 192, 3, 50.0, 10.0))
BA_ROLLOUT = BA_SHAPES[-1]
BA_BENCH = (64, 16, 192, 8)           # the batch benchmark's call
BA_SWEEP = ((64, 10, 48, 8), (64, 10, 128, 8), (32, 16, 256, 8),
            (8, 24, 512, 8))
# K3 and its plain version differ in the reduced solve (Gauss-Jordan against
# Cholesky) and in summation order: they agree by tolerance on consistent
# windows (the JAX package's tests/test_ba_pallas.py), not bit for bit
BA_POS_ATOL_M = 2e-4
BA_QUAT_ATOL = 2e-5
BA_PTS_ATOL_M = 1e-3
BA_COST_RTOL = 1e-3
BA_TRUTH_POS_M = 0.05                 # convergence to the generator's truth
BA_TRUTH_PTS_MEAN_M = 0.1

# the card's published peaks (NVIDIA's H100 SXM data sheet, 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12        # 32-bit operations outside the tensor cores

# fixture tolerances (GPU vs the JAX CPU reference): float32 rounding of
# sin/cos/exp and fused multiply-adds differs per device, ~1e-6 m per tick;
# the bounds leave room for that to accumulate over the window, and every
# discrete outcome must agree
FIX_TEACH_ATOL_M = 1e-2
FIX_REPEAT_ATOL_M = 5e-2
FIX_OCC_MISMATCH_FRAC = 0.01
# the ours replay also holds the estimates: the teach VIO track and the
# waypoints taken from it, and the repeat's fused nav pose, whose rounding
# grows through the relay's alignment and the anchors' corrections
FIX_VIO_ATOL_M = 1e-3
FIX_NAV_ATOL_M = 1e-2
DIVERGE_M = 1e-4   # "divergence starts" at the first tick beyond this
# the rgbd_ba replay holds the traces up to this tick and the refined ring
# and map at the end of the window
RGBD_FIX_TICKS = 150
FIX_BA_KF_ATOL_M = 1e-3
# The map is not held point by point against the JAX fixture: ``observe``
# orders the live features by their float32 distance and draws its noise per
# row, so two features at one distance to the last bit swap rows between the
# card and the CPU and their map points take each other's depth noise (up to
# 0.1 m, decaying as the running mean goes on), whatever solver refines
# them.  Against the fixture: the masks, the keyframes, and the share of map
# points within FIX_BA_MAP_BULK_ATOL_M.  The kernel's part is held card
# against card: every window against a float64 solve of the same window
# (BA_POS_ATOL_M, BA_PTS_ATOL_M), and the replay's final ring and map
# against the replay with the plain float32 version in its place.
FIX_BA_MAP_BULK_ATOL_M = 1e-3
FIX_BA_MAP_BULK_FRAC = 0.95
FIX_BA_SOLVER_ATOL_M = 1e-3
OURS_DISCRETE = ("regime", "anchor_ok", "anchor_reason", "vio_tracked",
                 "wp_idx", "done")


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def gt_config():
    """The GT-localized campaign of the first slice (no teach VIO)."""
    from nclt_slam_tpu_torch import config
    base = config.gt_localization()
    return base.replace(teach=dataclasses.replace(base.teach, run_vio=False))


def bound_ms(n_bytes: float, n_ops: float):
    """(least time in ms, what bounds it) to move ``n_bytes`` and do
    ``n_ops`` 32-bit operations at the card's published peaks."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_cuda(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def reset_counts():
    from nclt_slam_tpu_torch.ops import ba as ops_ba
    from nclt_slam_tpu_torch.ops import hamming as hm
    from nclt_slam_tpu_torch.ops import wavefront as wf
    wf.wavefront_relax.launches = 0
    hm.reset_launches()
    ops_ba.reset_launches()


def read_counts():
    from nclt_slam_tpu_torch.ops import ba as ops_ba
    from nclt_slam_tpu_torch.ops import hamming as hm
    from nclt_slam_tpu_torch.ops import wavefront as wf
    return dict(k2=wf.wavefront_relax.launches, k1=hm.cross_check.launches,
                k1_sites=dict(hm.cross_check.site_launches),
                k3=ops_ba.solve_ba_cuda.launches,
                k3_sites=dict(ops_ba.solve_ba_cuda.site_launches))


def build_phase():
    """Build every kernel, one nvcc per source, all at once."""
    from nclt_slam_tpu_torch.ops import ba as ops_ba
    from nclt_slam_tpu_torch.ops import hamming as hm
    from nclt_slam_tpu_torch.ops import wavefront as wf

    mods = (wf, hm, ops_ba)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods)) as ex:
        libs = list(ex.map(lambda m: m.build_library(), mods))
    for m in mods:
        m._load()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s: "
          + ", ".join(str(lib.relative_to(REPO)) for lib in libs), flush=True)


def kernel_phase(dev):
    """K2 against its plain version at the main path's shapes."""
    import torch
    from nclt_slam_tpu_torch.ops import wavefront as wf

    g = torch.Generator().manual_seed(0)
    rows = []
    for B, H, W in KERNEL_SHAPES:
        tc = torch.rand(B, H, W, generator=g) * 2.0 + 0.1
        tc[torch.rand(B, H, W, generator=g) < 0.15] = wf.BIG
        phi0 = torch.full((B, H, W), wf.BIG)
        gr = torch.randint(0, H, (B,), generator=g)
        gc = torch.randint(0, W, (B,), generator=g)
        phi0[torch.arange(B), gr, gc] = 0.0
        tc, phi0 = tc.to(dev), phi0.to(dev)
        out = wf.wavefront_relax(tc, phi0, KERNEL_ITERS)
        ref = wf.wavefront_relax_plain(tc, phi0, KERNEL_ITERS)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        check(torch.equal(out, ref),
              f"K2 differs from its plain version at {(B, H, W)}: "
              f"max abs err {err}")
        check((out < 1e8).float().mean().item() > 0.5,
              f"K2 at {(B, H, W)}: most cells unreachable")
        ms = time_cuda(lambda: wf.wavefront_relax(tc, phi0, KERNEL_ITERS), 20)
        plain_ms = time_cuda(
            lambda: wf.wavefront_relax_plain(tc, phi0, KERNEL_ITERS), 3)
        # per Jacobi iteration and cell: 8 neighbour adds, 8 mins, the
        # diagonal multiply and the final min; tc and phi0 read once, the
        # potential written once
        b_ms, b_by = bound_ms(3 * B * H * W * 4,
                              18 * B * H * W * KERNEL_ITERS)
        rows.append(dict(shape=[B, H, W], max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by))
        print(f"K2 {B}x{H}x{W} x{KERNEL_ITERS}: equal to plain, "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{b_ms:.4f} ms ({b_by})", flush=True)
    return rows


def hamming_phase(dev):
    """K1 against its plain version at the main path's shapes."""
    import torch
    from nclt_slam_tpu_torch.ops import hamming as hm

    g = torch.Generator().manual_seed(1)
    rows = []
    for P, A, Q, B in HAMMING_SHAPES:
        W = DESC_WORDS
        grp = P // Q
        da = torch.randint(0, 2 ** 32, (P, A, W), generator=g)
        db = torch.randint(0, 2 ** 32, (Q, B, W), generator=g)
        n = min(A, B) // 2
        db[:, :n] = da[::grp, :n]                          # shared rows
        db[:, n:n + n // 2] = da[::grp, n:n + n // 2] ^ 4  # near ties
        va = torch.rand(P, A, generator=g) > 0.2
        vb = torch.rand(Q, B, generator=g) > 0.2
        va[P // 2] = False                                 # all invalid
        args = [t.to(dev) for t in (da, va, db, vb)]
        out = hm.cross_check(*args, site="check")
        ref = hm.cross_check_plain(*args)
        torch.cuda.synchronize()
        err = max((o.to(torch.int64) - r.to(torch.int64)).abs().max().item()
                  for o, r in zip(out, ref))
        for name, o, r in zip(("best_b", "matched", "best_d"), out, ref):
            check(torch.equal(o, r), f"K1 {name} differs from its plain "
                  f"version at {(P, A, Q, B)}")
        check(bool(ref[1].any()), f"K1 at {(P, A, Q, B)}: nothing matched")
        ms = time_cuda(lambda: hm.cross_check(*args, site="check"), 50)
        plain_ms = time_cuda(lambda: hm.cross_check_plain(*args), 5)
        # one distance matrix: xor + popcount + add per word pair; the
        # descriptors (int64 words) and flags read once, two int32 and a
        # bool written per a-row
        b_ms, b_by = bound_ms(8 * W * (P * A + Q * B) + P * A + Q * B
                              + 9 * P * A, 3 * P * A * B * W)
        rows.append(dict(shape=[P, A, Q, B, W], max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         matched=int(ref[1].sum())))
        print(f"K1 {P}x{A} vs {Q}x{B}, {W} words: equal to plain "
              f"({int(ref[1].sum())} matched), kernel {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, bound {b_ms:.5f} ms ({b_by})", flush=True)
    return rows


# initial-estimate noise of a consistent window: keyframe position (m),
# rotation (rad) and landmark position (m)
POSE_NOISE, ROT_NOISE, PT_NOISE = 0.15, 0.03, 0.2


def make_problem(K: int = 6, P: int = 64, seed: int = 0):
    """One consistent BA window as numpy arrays, the synthetic window of the
    JAX package's ``tests/test_ba.py`` with the same draws from
    ``numpy.random.RandomState`` in the same order: observations are
    projections of true points, so every solver converges to one optimum.
    Returns (fields of a BAProblem without the batch dimension as a dict,
    gt_pos, gt_quat, pts)."""
    import numpy as np
    import torch
    from nclt_slam_tpu_torch import config as cfg_mod
    from nclt_slam_tpu_torch.core.quat import (
        quat_conj, quat_from_yaw, quat_mul, quat_to_mat, so3_exp)

    cam = cfg_mod.DEFAULT.camera
    rng = np.random.RandomState(seed)
    f32 = torch.float32
    gt_pos = np.stack([np.linspace(0, 5, K),
                       0.2 * np.sin(np.linspace(0, 2, K)),
                       np.full(K, 0.5)], -1)
    gt_quat_t = quat_from_yaw(torch.tensor(np.linspace(0, 0.4, K), dtype=f32))
    gt_quat = gt_quat_t.numpy()
    pts = np.stack([rng.uniform(3, 14, P), rng.uniform(-6, 6, P),
                    rng.uniform(0.2, 2.5, P)], -1)

    # project every point into every keyframe (float32, as the original)
    R = quat_to_mat(gt_quat_t)                               # (K, 3, 3)
    d = torch.tensor(pts, dtype=f32)[None] - \
        torch.tensor(gt_pos, dtype=f32)[:, None]
    y = torch.matmul(d, R)                                   # R^T d
    pc0, pc1 = -y[..., 1], -(y[..., 2] - cam.cam_offset_up)
    z = y[..., 0] - cam.cam_offset_fwd
    zc = z.clamp_min(0.1)
    uv = torch.stack([cam.fx * pc0 / zc + cam.cx,
                      cam.fy * pc1 / zc + cam.cy], -1).numpy()
    z = z.numpy()
    obs_uv = np.zeros((K, P, 2))
    obs_z = np.zeros((K, P))
    obs_w = np.zeros((K, P))
    for k in range(K):
        for p in range(P):
            if 0 < uv[k, p, 0] < 640 and 0 < uv[k, p, 1] < 480 and \
                    0.5 < z[k, p] < 15:
                obs_uv[k, p] = uv[k, p] + rng.normal(0, 0.5, 2)
                obs_z[k, p] = float(z[k, p]) * (1 + rng.normal(0, 0.01))
                obs_w[k, p] = 1.0

    Rn = R.numpy()
    rel_dp = np.einsum("kij,ki->kj", Rn[:-1],
                       (gt_pos[1:] - gt_pos[:-1]).astype(np.float32))
    rel_dq = quat_mul(quat_conj(gt_quat_t[:-1]), gt_quat_t[1:]).numpy()

    pos0 = np.array(gt_pos + rng.normal(0, POSE_NOISE, (K, 3)))
    pos0[0] = gt_pos[0]
    quat0 = quat_mul(gt_quat_t, so3_exp(torch.tensor(
        rng.normal(0, ROT_NOISE, (K, 3)), dtype=f32))).numpy().copy()
    quat0[0] = gt_quat[0]
    pts0 = pts + rng.normal(0, PT_NOISE, (P, 3))
    fields = dict(kf_pos=pos0, kf_quat=quat0, points=pts0, obs_uv=obs_uv,
                  obs_z=obs_z, obs_w=obs_w, rel_dp=rel_dp, rel_dq=rel_dq)
    return ({k: np.asarray(v, np.float32) for k, v in fields.items()},
            gt_pos, gt_quat, pts)


def _stack(windows, device, w_rel, prior):
    import numpy as np
    import torch
    from nclt_slam_tpu_torch.vio.ba import BAProblem

    fields = {k: torch.from_numpy(np.stack([w[k] for w in windows])).to(device)
              for k in windows[0]}
    B, P = fields["points"].shape[:2]
    return BAProblem(
        **fields, w_rel=w_rel,
        pt_prior_w=None if prior is None else
        torch.full((B, P), float(prior), device=device))


def consistent_windows(seeds, device, K: int = 6, P: int = 64,
                       w_rel: float = 100.0, prior: float | None = None):
    """A batch of ``make_problem`` windows on ``device``: (BAProblem,
    (gt_pos (B, K, 3), pts (B, P, 3)) as numpy)."""
    import numpy as np
    made = [make_problem(K=K, P=P, seed=s) for s in seeds]
    prob = _stack([m[0] for m in made], device, w_rel, prior)
    return prob, (np.stack([m[1] for m in made]),
                  np.stack([m[3] for m in made]))


def bench_problem(seed: int, K: int, P: int) -> dict:
    """One random window of the JAX package's batch benchmark
    (``bench.py:_bench_ba``), as numpy arrays.  Its observations are
    inconsistent: only "finite and the cost did not rise" can be asked of a
    solve."""
    import numpy as np
    r = np.random.RandomState(seed)
    ident = np.array([0.0, 0.0, 0.0, 1.0])
    fields = dict(
        kf_pos=np.cumsum(r.normal(0.5, 0.1, (K, 3)), 0),
        kf_quat=np.tile(ident, (K, 1)),
        points=r.uniform(2, 14, (P, 3)),
        obs_uv=r.uniform(0, 640, (K, P, 2)),
        obs_z=r.uniform(1, 12, (K, P)),
        obs_w=r.rand(K, P) < 0.4,
        rel_dp=r.normal(0.5, 0.1, (K - 1, 3)),
        rel_dq=np.tile(ident, (K - 1, 1)))
    return {k: np.asarray(v, np.float32) for k, v in fields.items()}


def bench_windows(batch: int, K: int, P: int, device):
    """The benchmark's batch: windows of seeds 0..batch-1, ``w_rel`` 100,
    free points."""
    return _stack([bench_problem(s, K, P) for s in range(batch)], device,
                  100.0, None)


def ba_flops_per_iter(K: int, P: int) -> float:
    """The operation count that the JAX package's ``bench.py`` uses for one
    Gauss-Newton iteration (its ``_ba_flops_per_iter``).  It counts a dense
    window with every observation present, the full (unsymmetric) Schur
    product 216 K^2 P and 1,920 operations an observation: more than the
    solve needs.  Printed beside the bound as a side figure only."""
    return (K * P * 1500.0 + K * P * 420.0
            + 216.0 * K * K * P + 108.0 * K * P
            + 120.0 * P + 144.0 * K ** 3)


# What one Gauss-Newton iteration needs, counted from the arithmetic of
# csrc/ba.cu with each product taken once (a multiply, an add, a compare, a
# divide and a square root count one each).  Per observation of weight > 0:
OPS_OBSERVE = 100      # residual 37, weight 13, Jacobian factors 13, Jl 21,
#                        Jr 16 (``observe``)
OPS_POINT_BLOCK = 63   # upper half of Jl^T w Jl (6 x 7) and Jl^T w r (3 x 7)
OPS_POSE_BLOCK = 189   # upper half of Jp^T w Jp (21 x 7) and Jp^T w r (6 x 7)
OPS_COST = 7
OPS_B = 108            # B = Jp^T w Jl, 18 entries x 6
OPS_C = 90             # C = B A^-1, 18 entries x 5
OPS_SCHUR_RHS = 36     # C g_l, 6 entries x 6
OPS_BACK_SUB = 36      # B^T dx, 3 entries x 12
OPS_PER_OBS = (OPS_OBSERVE + OPS_POINT_BLOCK + OPS_POSE_BLOCK + OPS_COST
               + OPS_B + OPS_C + OPS_SCHUR_RHS + OPS_BACK_SUB)
# per landmark and pair of keyframes that both see it, S is symmetric: a
# 6 x 6 block C_a B_b^T for a < b (36 entries x 6), the upper half of one
# for a = b (21 x 6)
OPS_SCHUR_PAIR, OPS_SCHUR_DIAG = 216, 126
OPS_PER_POINT = 68     # prior and damping, the adjugate inverse, the prior's
#                        gradient, dX = -A^-1 (g_l + B^T dx)
OPS_REL_FACTOR = 2000  # residual, analytic Jacobians, its three 6 x 6 blocks
OPS_POSE_UPDATE = 100  # so3_exp, a quaternion product, the normalization


def ba_ops_per_iter(obs_w) -> float:
    """Operations that one Gauss-Newton iteration needs on these windows
    (obs_w (B, K, P); an observation of weight 0 adds nothing to any sum and
    needs nothing): the per-observation terms, the symmetric half of the
    Schur product over the keyframe pairs that share a landmark, and the
    least a dense direct solve of the symmetric reduced system takes
    (Cholesky, N^3 / 3, and two triangular solves, 2 N^2, N = 6 K)."""
    B, K, P = obs_w.shape
    seen = obs_w > 0
    n_obs = int(seen.sum())
    n_p = seen.sum(1).double()                               # (B, P)
    pairs = float((n_p * (n_p - 1) / 2).sum())
    N = 6 * K
    return (n_obs * OPS_PER_OBS + pairs * OPS_SCHUR_PAIR
            + n_obs * OPS_SCHUR_DIAG
            + B * (P * OPS_PER_POINT + N ** 3 / 3 + 2 * N * N
                   + (K - 1) * OPS_REL_FACTOR + K * OPS_POSE_UPDATE))


def ba_bound(prob, iters):
    """(ms, what bounds it) for one solve of ``prob``: every input read once
    (poses, landmarks, observations, relative factors with their weights,
    point prior), every output written once, and ``ba_ops_per_iter``."""
    B, K, P = prob.obs_w.shape
    n_in = B * (K * 7 + P * 3 + K * P * 4 + (K - 1) * 8 + P)
    n_out = B * (K * 7 + P * 3 + 1)
    return bound_ms(4 * (n_in + n_out), ba_ops_per_iter(prob.obs_w) * iters)


def ba_phase(dev):
    """K3 against its plain version on consistent windows, then its times
    at the rollout's and the batch benchmark's shapes."""
    import numpy as np
    import torch
    from nclt_slam_tpu_torch import config
    from nclt_slam_tpu_torch.vio import ba

    cam, vcfg = config.DEFAULT.camera, config.DEFAULT.vio
    rows = []
    for shape in BA_SHAPES:
        B, K, P, iters, prior, w_rel = shape
        prob, (gt_pos, gt_pts) = consistent_windows(
            range(B), dev, K=K, P=P, w_rel=w_rel, prior=prior)
        out = ba.solve_ba(prob, cam, vcfg, iters=iters, site="check")
        ref = ba.solve_ba_plain(prob, cam, vcfg, iters=iters)
        torch.cuda.synchronize()
        err = {f: (getattr(out, f) - getattr(ref, f)).abs().max().item()
               for f in ("kf_pos", "kf_quat", "points")}
        cost_rel = ((out.final_cost - ref.final_cost).abs()
                    / ref.final_cost.abs()).max().item()
        check(all(torch.isfinite(x).all().item() for x in out),
              f"K3 at {shape}: non-finite output")
        check(err["kf_pos"] <= BA_POS_ATOL_M
              and err["kf_quat"] <= BA_QUAT_ATOL
              and err["points"] <= BA_PTS_ATOL_M
              and cost_rel <= BA_COST_RTOL,
              f"K3 differs from its plain version at {shape}: {err}, cost "
              f"{cost_rel} relative")
        truth = {}
        for name, res in (("kernel", out), ("plain", ref)):
            pe = np.linalg.norm(res.kf_pos.cpu().numpy() - gt_pos,
                                axis=-1).max()
            le = np.linalg.norm(res.points.cpu().numpy() - gt_pts,
                                axis=-1).mean()
            truth[name] = (float(pe), float(le))
            # free points and a full-length solve reach the truth; a prior
            # holds the points at their noisy input
            if prior is None and iters >= 10:
                check(pe < BA_TRUTH_POS_M and le < BA_TRUTH_PTS_MEAN_M,
                      f"{name} BA at {shape} did not converge to the truth: "
                      f"poses {pe} m, points {le} m mean")
        rows.append(dict(shape=list(shape[:4]), max_abs_err=max(err.values()),
                         cost_rel_err=cost_rel, **err))
        print(f"K3 {B}x{K}x{P} x{iters}: within tolerance of plain (pos "
              f"{err['kf_pos']:.2e} m, quat {err['kf_quat']:.2e}, points "
              f"{err['points']:.2e} m, cost {cost_rel:.2e} rel); to truth "
              f"(max pose m, mean point m): kernel {truth['kernel']}, plain "
              f"{truth['plain']}", flush=True)

    def timed(name, prob, B, K, P, iters, reps):
        out = ba.solve_ba(prob, cam, vcfg, iters=iters, site="check")
        first = ba.solve_ba(prob, cam, vcfg, iters=1, site="check")
        torch.cuda.synchronize()
        check(all(torch.isfinite(x).all().item() for x in out),
              f"K3 {name}: non-finite output")
        check((out.final_cost <= first.final_cost).all().item(),
              f"K3 {name}: the cost rose over {iters} iterations")
        ms = time_cuda(lambda: ba.solve_ba(prob, cam, vcfg, iters=iters,
                                           site="check"), reps)
        plain_ms = time_cuda(lambda: ba.solve_ba_plain(prob, cam, vcfg,
                                                       iters=iters), 3)
        b_ms, b_by = ba_bound(prob, iters)
        dense_ms = ba_flops_per_iter(K, P) * iters * B / PEAK_OPS_PER_S * 1e3
        row = dict(shape=[B, K, P, iters], ms=ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, solves_per_s=B / ms * 1e3,
                   observed_frac=(prob.obs_w > 0).float().mean().item(),
                   dense_count_ms=dense_ms)
        print(f"K3 {name} {B}x{K}x{P} x{iters}: kernel {ms:.3f} ms "
              f"({row['solves_per_s']:.0f} solves/s), plain {plain_ms:.2f} "
              f"ms, bound {b_ms:.5f} ms ({b_by}; "
              f"{row['observed_frac']:.2f} of the observations present; the "
              f"JAX benchmark's dense count gives {dense_ms:.4f} ms)",
              flush=True)
        return row

    B, K, P, iters, prior, w_rel = BA_ROLLOUT
    prob, _ = consistent_windows(range(B), dev, K=K, P=P, w_rel=w_rel,
                                 prior=prior)
    rollout = timed("rollout", prob, B, K, P, iters, 50)
    rollout["max_abs_err"] = rows[-1]["max_abs_err"]
    B, K, P, iters = BA_BENCH
    bench = timed("bench", bench_windows(B, K, P, dev), B, K, P, iters, 20)
    sweep = [timed("sweep", bench_windows(B, K, P, dev), B, K, P, iters, 10)
             for B, K, P, iters in BA_SWEEP]
    return dict(checks=rows, rollout=rollout, bench=bench, sweep=sweep)


def divergence(a, b):
    """(max abs error, first tick beyond DIVERGE_M or None) of two (R, T, 2)
    traces, worst route per tick."""
    import numpy as np
    d = np.abs(np.asarray(a) - np.asarray(b)).max(-1).max(0)
    over = np.flatnonzero(d > DIVERGE_M)
    return float(d.max()), (int(over[0]) if len(over) else None)


def first_diff(a, b):
    """First tick at which two (R, T) sequences differ, or None."""
    import numpy as np
    bad = np.flatnonzero((np.asarray(a) != np.asarray(b)).any(0))
    return int(bad[0]) if len(bad) else None


def fixture_phase(dev):
    """Replay the JAX reference GT campaign (2 routes) and compare."""
    import numpy as np
    import torch
    from nclt_slam_tpu_torch.rollout import campaign

    fx = np.load(FIXTURE)
    names = [str(n) for n in fx["routes"]]
    n_teach = fx["teach_gt_xy"].shape[1]
    n_rep = fx["repeat_gt_xy"].shape[1]
    cfg = gt_config()
    data = campaign.build_campaign(names, cfg=cfg, device=dev)
    teach = campaign.run_campaign_teach(data, cfg, n_teach,
                                        stop_when_done=False)
    wps, n_wps = campaign.teach_waypoints(data, teach, cfg)
    rep = campaign.run_campaign_repeat(data, teach.teach_grid, wps, n_wps,
                                       cfg, n_rep, stop_when_done=False)

    t_err, t_start = divergence(teach.trace.gt_xy, fx["teach_gt_xy"])
    r_err, r_start = divergence(rep.trace.gt_xy, fx["repeat_gt_xy"])
    grid = teach.teach_grid.cpu().numpy()
    occ_ref = np.split(fx["teach_occupied_idx"],
                       np.cumsum(fx["teach_occupied_n"])[:-1])
    mismatch = []
    for g, ref in zip(grid, occ_ref):
        got = np.flatnonzero(g == 2)
        sym = len(np.setxor1d(got, ref))
        mismatch.append(sym / max(len(ref), 1))
    report = dict(
        routes=names, teach_ticks=n_teach, repeat_ticks=n_rep,
        teach_gt_xy_max_err_m=t_err,
        teach_divergence_from_tick=t_start,
        repeat_gt_xy_max_err_m=r_err,
        repeat_divergence_from_tick=r_start,
        teach_occupied_mismatch_frac=max(mismatch),
        n_wps=n_wps.cpu().tolist(), n_wps_ref=fx["n_wps"].tolist(),
        wp_idx_equal=bool(np.array_equal(rep.trace.wp_idx,
                                         fx["repeat_wp_idx"])),
        done_equal=bool(np.array_equal(rep.trace.done, fx["repeat_done"])),
        fired_equal=bool(np.array_equal(rep.trace.fired,
                                        fx["repeat_fired"])),
        store_count=teach.store.count.cpu().tolist(),
        store_count_ref=fx["store_count"].tolist())
    print("fixture " + json.dumps(report), flush=True)
    check(t_err <= FIX_TEACH_ATOL_M, f"teach diverged from the JAX fixture "
          f"({t_err} m > {FIX_TEACH_ATOL_M} m)")
    check(r_err <= FIX_REPEAT_ATOL_M, f"repeat diverged from the JAX "
          f"fixture ({r_err} m > {FIX_REPEAT_ATOL_M} m)")
    check(np.array_equal(teach.trace.done, fx["teach_done"]),
          "teach done flags differ from the fixture")
    check(report["n_wps"] == report["n_wps_ref"],
          "teach waypoint counts differ from the fixture")
    check(report["wp_idx_equal"] and report["done_equal"]
          and report["fired_equal"],
          "repeat waypoint/done/fire sequence differs from the fixture")
    check(max(mismatch) <= FIX_OCC_MISMATCH_FRAC,
          f"teach map occupied cells differ by {max(mismatch):.4f}")
    torch.cuda.synchronize()
    return report


def ours_fixture_phase(dev):
    """Replay the JAX reference ours campaign (2 routes) and compare."""
    import numpy as np
    from nclt_slam_tpu_torch import config
    from nclt_slam_tpu_torch.rollout import campaign

    fx = np.load(OURS_FIXTURE)
    names = [str(n) for n in fx["routes"]]
    n_teach = fx["teach_gt_xy"].shape[1]
    n_rep = fx["repeat_gt_xy"].shape[1]
    teach_cfg, cfg = config.gt_localization(), config.ours()
    data = campaign.build_campaign(names, cfg=teach_cfg, device=dev)
    teach = campaign.run_campaign_teach(data, teach_cfg, n_teach,
                                        stop_when_done=False)
    wps, n_wps = campaign.teach_waypoints(data, teach, cfg)
    rep = campaign.run_campaign_repeat(data, teach.teach_grid, wps, n_wps,
                                       cfg, n_rep, stores=teach.store,
                                       stop_when_done=False)
    t, r = teach.trace, rep.trace
    t_err, t_start = divergence(t.gt_xy, fx["teach_gt_xy"])
    v_err, v_start = divergence(t.vio_xy, fx["teach_vio_xy"])
    r_err, r_start = divergence(r.gt_xy, fx["repeat_gt_xy"])
    n_err, n_start = divergence(r.nav_xy, fx["repeat_nav_xy"])
    n_ref = int(fx["n_wps"].max())
    wp_err = float(np.abs(wps.cpu().numpy()[:, :n_ref]
                          - fx["wps"][:, :n_ref]).max())
    report = dict(
        routes=names, teach_ticks=n_teach, repeat_ticks=n_rep,
        teach_gt_xy_max_err_m=t_err, teach_divergence_from_tick=t_start,
        teach_vio_xy_max_err_m=v_err, teach_vio_divergence_from_tick=v_start,
        teach_done_equal=bool(np.array_equal(t.done, fx["teach_done"])),
        teach_vio_tracked_first_diff=first_diff(t.vio_tracked,
                                                fx["teach_vio_tracked"]),
        n_wps=n_wps.cpu().tolist(), n_wps_ref=fx["n_wps"].tolist(),
        vio_wps_max_err_m=wp_err,
        repeat_gt_xy_max_err_m=r_err, repeat_divergence_from_tick=r_start,
        repeat_nav_xy_max_err_m=n_err, repeat_nav_divergence_from_tick=n_start,
        committed=rep.final.fusion.committed.cpu().tolist(),
        committed_ref=fx["repeat_committed"].tolist(),
        anchors_published=int(r.anchor_ok.sum()),
        anchors_published_ref=int(fx["repeat_anchor_ok"].sum()))
    for f in OURS_DISCRETE:
        report[f"{f}_first_diff"] = first_diff(getattr(r, f),
                                               fx[f"repeat_{f}"])
    print("ours_fixture " + json.dumps(report), flush=True)
    check(t_err <= FIX_TEACH_ATOL_M, f"ours teach diverged from the "
          f"JAX fixture ({t_err} m)")
    check(v_err <= FIX_VIO_ATOL_M, f"ours teach VIO track diverged from "
          f"the JAX fixture ({v_err} m > {FIX_VIO_ATOL_M} m)")
    check(report["teach_done_equal"], "ours teach done flags differ")
    check(report["teach_vio_tracked_first_diff"] is None,
          f"ours teach VIO match counts differ from the fixture from tick "
          f"{report['teach_vio_tracked_first_diff']}")
    check(report["n_wps"] == report["n_wps_ref"],
          "ours teach waypoint counts differ from the fixture")
    check(wp_err <= FIX_VIO_ATOL_M, f"ours VIO waypoints differ from the "
          f"fixture ({wp_err} m > {FIX_VIO_ATOL_M} m)")
    check(r_err <= FIX_REPEAT_ATOL_M, f"ours repeat diverged from "
          f"the JAX fixture ({r_err} m)")
    check(n_err <= FIX_NAV_ATOL_M, f"ours repeat nav pose diverged from "
          f"the JAX fixture ({n_err} m > {FIX_NAV_ATOL_M} m)")
    check(report["committed"] == report["committed_ref"],
          "relay commit differs from the fixture")
    for f in OURS_DISCRETE:
        check(report[f"{f}_first_diff"] is None,
              f"ours repeat {f} sequence differs from the fixture from tick "
              f"{report[f'{f}_first_diff']}")
    return data, teach, wps, n_wps


@contextlib.contextmanager
def watch_local_ba(n_routes, dev):
    """Count what the rollout's ``local_ba`` calls did while the block runs:
    per route, the solves that passed the ``enough`` gate (the keyframe ring
    moved) and the map points they wrote back.  Kept on the card: nothing
    synchronizes inside the run."""
    import torch
    from nclt_slam_tpu_torch.rollout import repeat as repeat_mod

    tally = dict(calls=0,
                 accepted=torch.zeros(n_routes, dtype=torch.long, device=dev),
                 points=torch.zeros(n_routes, dtype=torch.long, device=dev))
    inner = repeat_mod.local_ba

    def watched(state, cam, cfg):
        new = inner(state, cam, cfg)
        tally["calls"] += 1
        tally["accepted"] += (new.kf_pos != state.kf_pos).flatten(1).any(1)
        tally["points"] += (new.map_xyz != state.map_xyz).any(-1).sum(1)
        return new

    repeat_mod.local_ba = watched
    try:
        yield tally
    finally:
        repeat_mod.local_ba = inner


@contextlib.contextmanager
def swap_solve_ba(fn):
    """While the block runs, every ``vio.ba.solve_ba`` call (``local_ba``
    looks the name up at each call) goes to ``fn(inner, prob, cam, cfg,
    iters=, site=)``, ``inner`` being the real one."""
    from nclt_slam_tpu_torch.vio import ba

    inner = ba.solve_ba
    ba.solve_ba = lambda *a, **kw: fn(inner, *a, **kw)
    try:
        yield
    finally:
        ba.solve_ba = inner


def ba_gap(a, b):
    """(B, 2): per window, the largest keyframe-position and landmark
    coordinate difference of two BA results, in float64."""
    import torch
    return torch.stack([(a.kf_pos.double() - b.kf_pos.double())
                        .abs().flatten(1).amax(1),
                        (a.points.double() - b.points.double())
                        .abs().flatten(1).amax(1)], -1)


def final_map_errors(vio, fx):
    """The final keyframe ring and VIO map against the fixture's: (masks
    equal, worst keyframe m, worst map point m, share of the map points
    within FIX_BA_MAP_BULK_ATOL_M)."""
    import numpy as np
    kf_valid = vio.kf_valid.cpu().numpy()
    if not (np.array_equal(kf_valid, fx["final_kf_valid"])
            and np.array_equal(vio.kf_ptr.cpu().numpy(), fx["final_kf_ptr"])
            and np.array_equal(vio.map_valid.cpu().numpy(),
                               fx["final_map_valid"])):
        return False, None, None, None
    kf_err = float(np.abs(vio.kf_pos.cpu().numpy()
                          - fx["final_kf_pos"])[kf_valid].max())
    d_map = np.abs(vio.map_xyz.cpu().numpy()
                   - fx["final_map_xyz"])[fx["final_map_valid"]].max(-1)
    return True, kf_err, float(d_map.max()), \
        float((d_map <= FIX_BA_MAP_BULK_ATOL_M).mean())


def rgbd_ba_fixture_phase(shared, dev, solvers=("plain",)):
    """Replay the JAX reference ``rgbd_ba`` repeat (2 routes) off the ours
    fixture's teach and compare.  Every window that ``local_ba`` gives K3 is
    also solved by the plain version in float32 and in float64 (neither
    result is used by the run): the kernel must agree with the float64
    solve on the rollout's real windows (clamped depths, weight-0 rows,
    repeated slots, loose points) within the tolerances it is held to on
    synthetic ones, or be no further from it than twice the plain float32
    version is.  Then the replay is run again with each of ``solvers``
    in the kernel's place ("plain": the plain version in float32, with
    which the kernel's final ring and map must agree; "plain64", for
    diagnosis: in float64, the result rounded to float32, from which both
    float32 solvers drift in a loose map point over the window's solves).
    How far each replay lands from the fixture says what the solver has to
    do with that distance."""
    import numpy as np
    import torch
    from nclt_slam_tpu_torch.baselines import configs as baselines
    from nclt_slam_tpu_torch.rollout import campaign
    from nclt_slam_tpu_torch.vio import ba

    fx = np.load(RGBD_BA_FIXTURE)
    data, teach, wps, n_wps = shared
    check([str(n) for n in fx["routes"]] == list(data.names),
          "the rgbd_ba fixture's routes are not the ours fixture's")
    n_rep = fx["repeat_gt_xy"].shape[1]
    n = min(RGBD_FIX_TICKS, n_rep)
    cfg = baselines.rgbd_ba()

    def replay():
        return campaign.run_campaign_repeat(
            data, teach.teach_grid, wps, n_wps, cfg, n_rep,
            stores=teach.store, stop_when_done=False)

    def to64(prob):
        return ba.BAProblem(*(t.double() if torch.is_tensor(t) else t
                              for t in prob))

    gaps = []   # per local_ba call: (3, routes, 2)

    def held(inner, prob, cam, vcfg, iters=None, site="other"):
        out = inner(prob, cam, vcfg, iters=iters, site=site)
        ref32 = ba.solve_ba_plain(prob, cam, vcfg, iters)
        ref64 = ba.solve_ba_plain(to64(prob), cam, vcfg, iters)
        gaps.append(torch.stack([ba_gap(out, ref64), ba_gap(ref32, ref64),
                                 ba_gap(out, ref32)]))
        return out

    def plain_in_place(dtype):
        def solve(inner, prob, cam, vcfg, iters=None, site="other"):
            p = prob if dtype == torch.float32 else to64(prob)
            return ba.BAResult(*(t.float() for t in
                                 ba.solve_ba_plain(p, cam, vcfg, iters)))
        return solve

    before = read_counts()["k3_sites"].get("local_ba", 0)
    with watch_local_ba(len(data.names), dev) as tally, swap_solve_ba(held):
        rep = replay()
    k3 = read_counts()["k3_sites"].get("local_ba", 0) - before
    gaps = torch.stack(gaps).cpu().numpy()       # (calls, 3, routes, 2)
    others = {}
    for name in solvers:
        dtype = dict(plain=torch.float32, plain64=torch.float64)[name]
        with swap_solve_ba(plain_in_place(dtype)):
            other = replay()
        eq, kf_e, map_e, bulk = final_map_errors(other.final.vio, fx)
        o_vio, k_vio = other.final.vio, rep.final.vio
        others[name] = dict(
            kernel_replay_kf_pos_gap_m=(o_vio.kf_pos - k_vio.kf_pos)
            .abs().max().item(),
            kernel_replay_map_xyz_gap_m=(o_vio.map_xyz - k_vio.map_xyz)
            .abs().max().item(),
            masks_equal=eq, final_kf_pos_max_err_m=kf_e,
            final_map_xyz_max_err_m=map_e,
            final_map_frac_within_bulk_atol=bulk,
            vio_xy_max_err_m=divergence(other.trace.vio_xy[:, :n],
                                        fx["repeat_vio_xy"][:, :n])[0],
            vio_tracked_first_diff=first_diff(other.trace.vio_tracked,
                                              fx["repeat_vio_tracked"]))
    check(read_counts()["k3_sites"].get("local_ba", 0) - before == k3,
          "a replay with the plain version in place launched K3")
    r, vio = rep.trace, rep.final.vio
    r_err, r_start = divergence(r.gt_xy[:, :n], fx["repeat_gt_xy"][:, :n])
    n_err, n_start = divergence(r.nav_xy[:, :n], fx["repeat_nav_xy"][:, :n])
    v_err, v_start = divergence(r.vio_xy[:, :n], fx["repeat_vio_xy"][:, :n])
    kf_valid = vio.kf_valid.cpu().numpy()
    ring_equal, kf_err, map_err, map_bulk = final_map_errors(vio, fx)
    # per local_ba call, the worst route: (keyframes m, landmarks m)
    gap_rows = {name: gaps[:, i].max(1).tolist() for i, name in
                enumerate(("kernel_vs_f64", "plain_vs_f64",
                           "kernel_vs_plain"))}
    report = dict(
        routes=list(data.names), repeat_ticks=n_rep, held_ticks=n,
        repeat_gt_xy_max_err_m=r_err, repeat_divergence_from_tick=r_start,
        repeat_nav_xy_max_err_m=n_err, repeat_nav_divergence_from_tick=n_start,
        repeat_vio_xy_max_err_m=v_err, repeat_vio_divergence_from_tick=v_start,
        committed=rep.final.fusion.committed.cpu().tolist(),
        committed_ref=fx["repeat_committed"].tolist(),
        anchors_published=int(r.anchor_ok.sum()),
        anchors_published_ref=int(fx["repeat_anchor_ok"].sum()),
        k3_launches=k3, local_ba_calls=tally["calls"],
        local_ba_accepted=tally["accepted"].cpu().tolist(),
        local_ba_points_written=tally["points"].cpu().tolist(),
        ref_ba_ticks_with_3_keyframes=(fx["kf_before_ba"] >= 3).sum(1).tolist(),
        keyframes=kf_valid.sum(1).tolist(),
        ring_and_map_masks_equal=ring_equal,
        final_kf_pos_max_err_m=kf_err, final_map_xyz_max_err_m=map_err,
        final_map_frac_within_bulk_atol=map_bulk,
        window_gaps_kf_m_points_m=gap_rows, plain_in_place=others)
    for f in OURS_DISCRETE:
        report[f"{f}_first_diff"] = first_diff(getattr(r, f),
                                               fx[f"repeat_{f}"])
    print("rgbd_ba_fixture " + json.dumps(report), flush=True)
    check(k3 == tally["calls"] == n_rep // BA_PERIOD,
          f"the rgbd_ba replay launched K3 {k3} times in {tally['calls']} "
          f"local_ba calls over {n_rep} ticks")
    check(max(report["local_ba_accepted"]) >= 5,
          f"fewer than five accepted local-BA solves on every route: "
          f"{report['local_ba_accepted']}")
    check(r_err <= FIX_REPEAT_ATOL_M, f"rgbd_ba repeat diverged from the "
          f"JAX fixture ({r_err} m)")
    check(n_err <= FIX_NAV_ATOL_M, f"rgbd_ba nav pose diverged from the JAX "
          f"fixture ({n_err} m > {FIX_NAV_ATOL_M} m)")
    check(v_err <= FIX_NAV_ATOL_M, f"rgbd_ba VIO track diverged from the "
          f"JAX fixture ({v_err} m > {FIX_NAV_ATOL_M} m)")
    check(report["committed"] == report["committed_ref"],
          "rgbd_ba relay commit differs from the fixture")
    for f in OURS_DISCRETE:
        d = report[f"{f}_first_diff"]
        check(d is None or d >= n, f"rgbd_ba repeat {f} sequence differs "
              f"from the fixture from tick {d}")
    # per window: within the tolerance, or no further from the float64
    # solve than twice the plain float32 version is (an ill-conditioned
    # window rounds both apart)
    limit = np.maximum(np.array([BA_POS_ATOL_M, BA_PTS_ATOL_M]),
                       2.0 * gaps[:, 1])
    over = gaps[:, 0] > limit
    check(np.isfinite(gaps).all() and not over.any(),
          f"K3 differs from the float64 solve of a rollout window (call, "
          f"route, keyframes | landmarks): {np.argwhere(over).tolist()}, "
          f"worst {gaps[:, 0].max((0, 1)).tolist()} m")
    o = others["plain"]
    check(o["kernel_replay_kf_pos_gap_m"] <= FIX_BA_SOLVER_ATOL_M
          and o["kernel_replay_map_xyz_gap_m"] <= FIX_BA_SOLVER_ATOL_M,
          f"the replay through K3 ends away from the one through the plain "
          f"version: keyframes {o['kernel_replay_kf_pos_gap_m']} m, map "
          f"{o['kernel_replay_map_xyz_gap_m']} m")
    if n == n_rep:
        check(ring_equal, "rgbd_ba keyframe ring or map masks differ from "
              "the fixture")
        check(kf_err <= FIX_BA_KF_ATOL_M
              and map_bulk >= FIX_BA_MAP_BULK_FRAC,
              f"the refined ring / map differ from the fixture: keyframes "
              f"{kf_err} m, {map_bulk} of the map points within "
              f"{FIX_BA_MAP_BULK_ATOL_M} m (worst {map_err} m)")
    return report


def traces_finite(named):
    import numpy as np
    for name, arr in named:
        check(np.isfinite(np.asarray(arr)).all(),
              f"{name} has non-finite values")


def executed(n_ticks):
    from nclt_slam_tpu_torch.rollout import campaign
    n, chunk = campaign.planned_chunks(n_ticks, 250)
    return n * chunk


def main_path_phase(dev):
    """The 15-route GT-localized campaign through the campaign API."""
    import numpy as np
    import torch
    from nclt_slam_tpu_torch.rollout import campaign

    cfg = gt_config()
    t0 = time.perf_counter()
    data = campaign.build_campaign(cfg=cfg, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_routes = len(data.names)
    print(f"campaign built: {n_routes} routes, map "
          f"{cfg.map.rows}x{cfg.map.cols}, window {cfg.planner.window}, "
          f"rays {cfg.camera.ray_cols}x{cfg.camera.ray_rows}, "
          f"{data.scenes_teach.feat_xyz.shape[1]} features/route "
          f"({build_s:.1f} s)", flush=True)

    reset_counts()
    t0 = time.perf_counter()
    teach = campaign.run_campaign_teach(data, cfg, TEACH_TICKS,
                                        stop_when_done=False)
    torch.cuda.synchronize()
    teach_s = time.perf_counter() - t0
    wps, n_wps = campaign.teach_waypoints(data, teach, cfg)
    t0 = time.perf_counter()
    rep = campaign.run_campaign_repeat(data, teach.teach_grid, wps, n_wps,
                                       cfg, REPEAT_TICKS,
                                       stop_when_done=False)
    torch.cuda.synchronize()
    repeat_s = time.perf_counter() - t0
    counts = read_counts()

    rep_exec, teach_exec = executed(REPEAT_TICKS), executed(TEACH_TICKS)
    substeps = cfg.sim.nav_decimation
    check(counts["k2"] > 0, "the GT main path launched K2 no time")
    traces_finite((("teach gt_xy", teach.trace.gt_xy),
                   ("teach gt_yaw", teach.trace.gt_yaw),
                   ("repeat gt_xy", rep.trace.gt_xy),
                   ("repeat nav_xy", rep.trace.nav_xy),
                   ("repeat cmd_v", rep.trace.cmd_v)))
    teach_path = np.hypot(*np.diff(teach.trace.gt_xy, axis=1).T).sum(0)
    rep_path = np.hypot(*np.diff(rep.trace.gt_xy, axis=1).T).sum(0)
    check((teach_path > 5.0).all(), f"a teach robot did not move: "
          f"{teach_path.round(2).tolist()}")
    check((rep_path > 5.0).sum() >= n_routes - 2,
          f"repeat robots did not move: {rep_path.round(2).tolist()}")
    wp_idx = rep.final.dispatch.idx.cpu().numpy()
    check((wp_idx >= 2).all(), f"waypoints not reached: {wp_idx.tolist()}")
    check((teach.teach_grid == 2).sum().item() > 0,
          "teach map has no obstacles")
    _, agg = campaign.campaign_metrics(data, rep, wps, n_wps, cfg)
    stats = dict(
        routes=n_routes, teach_ticks=teach_exec, repeat_ticks=rep_exec,
        teach_s=teach_s, repeat_s=repeat_s,
        teach_env_steps_per_s=teach_exec * substeps * n_routes / teach_s,
        env_steps_per_s=rep_exec * substeps * n_routes / repeat_s,
        launches=counts,
        repeat_path_m_mean=float(rep_path.mean()),
        wp_idx=wp_idx.tolist(), n_wps=n_wps.cpu().tolist(),
        landmarks=teach.store.count.cpu().tolist())
    print("gt_campaign_metrics " + json.dumps(agg), flush=True)
    print("gt_main_path " + json.dumps(stats), flush=True)
    return stats


def profile_window(fn):
    """Run ``fn`` under torch.profiler: (kernel launches, device busy
    seconds, wall seconds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    launches = sum(e.count for e in ka if e.key == "cudaLaunchKernel")
    busy_us = sum(e.self_device_time_total for e in ka
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return launches, busy_us * 1e-6, wall


def ours_main_path_phase(dev):
    """The 15-route ours campaign (VIO teach, full-stack repeat) through
    the campaign API."""
    import numpy as np
    import torch
    from nclt_slam_tpu_torch import config
    from nclt_slam_tpu_torch.landmarks import matcher
    from nclt_slam_tpu_torch.rollout import campaign

    teach_cfg, cfg = config.gt_localization(), config.ours()
    data = campaign.build_campaign(cfg=teach_cfg, device=dev)
    n_routes = len(data.names)
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    teach = campaign.run_campaign_teach(data, teach_cfg, OURS_TEACH_TICKS,
                                        stop_when_done=False)
    torch.cuda.synchronize()
    teach_s = time.perf_counter() - t0
    wps, n_wps = campaign.teach_waypoints(data, teach, cfg)   # source="vio"
    t0 = time.perf_counter()
    rep = campaign.run_campaign_repeat(data, teach.teach_grid, wps, n_wps,
                                       cfg, OURS_REPEAT_TICKS,
                                       stores=teach.store,
                                       stop_when_done=False)
    torch.cuda.synchronize()
    repeat_s = time.perf_counter() - t0
    counts = read_counts()

    sites = counts["k1_sites"]
    check(sites.get("vio", 0) > 0, "the ours path launched K1 in vio_frame "
          "no time")
    check(sites.get("matcher", 0) > 0, "the ours path launched K1 in "
          "match_tick no time")
    check(counts["k2"] > 0, "the ours path launched K2 no time")
    t, r = teach.trace, rep.trace
    traces_finite((("teach gt_xy", t.gt_xy), ("teach vio_xy", t.vio_xy),
                   ("repeat gt_xy", r.gt_xy), ("repeat nav_xy", r.nav_xy),
                   ("repeat vio_xy", r.vio_xy), ("repeat cmd_v", r.cmd_v)))
    committed = rep.final.fusion.committed.cpu().numpy()
    check(committed.all(), f"relays not committed: {committed.tolist()}")
    n_pub = r.anchor_ok.sum(1)
    check(n_pub.sum() > 0, "no route published an anchor")
    teach_path = np.hypot(*np.diff(t.gt_xy, axis=1).T).sum(0)
    rep_path = np.hypot(*np.diff(r.gt_xy, axis=1).T).sum(0)
    check((teach_path > 5.0).all(), f"a teach robot did not move: "
          f"{teach_path.round(2).tolist()}")
    check((rep_path > 2.0).sum() >= n_routes - 2,
          f"repeat robots did not move: {rep_path.round(2).tolist()}")
    reasons = r.anchor_reason[r.anchor_reason >= 0]
    names = {matcher.R_PUBLISHED: "published",
             matcher.R_NO_CANDIDATES: "no_candidates",
             matcher.R_NO_FEATURES: "no_features",
             matcher.R_NO_PNP_ACCEPT: "no_pnp_accept",
             matcher.R_CONSISTENCY_FAIL: "consistency_fail"}
    reason_counts = {names[k]: int((reasons == k).sum()) for k in names}
    # the startup hold releases the robot once its relay has committed
    first_drive = [int(np.argmax(row != 0)) for row in r.cmd_v]

    rep_exec, teach_exec = executed(OURS_REPEAT_TICKS), \
        executed(OURS_TEACH_TICKS)
    substeps = cfg.sim.nav_decimation
    _, agg = campaign.campaign_metrics(data, rep, wps, n_wps, cfg)
    drift = np.hypot(*(r.nav_xy - r.gt_xy).transpose(2, 0, 1))
    stats = dict(
        routes=n_routes, teach_ticks=teach_exec, repeat_ticks=rep_exec,
        teach_s=teach_s, repeat_s=repeat_s,
        teach_env_steps_per_s=teach_exec * substeps * n_routes / teach_s,
        env_steps_per_s=rep_exec * substeps * n_routes / repeat_s,
        teach_ms_per_tick=teach_s / teach_exec * 1e3,
        repeat_ms_per_tick=repeat_s / rep_exec * 1e3,
        launches=counts,
        # the VIO frame launches K1 once a tick in teach and repeat, the
        # matcher once every fifth repeat tick
        k1_launches_per_repeat_tick=(sites.get("vio", 0) - teach_exec
                                     + sites.get("matcher", 0)) / rep_exec,
        anchors_published_per_route=n_pub.tolist(),
        anchor_reasons=reason_counts,
        first_drive_tick=first_drive,
        nav_err_m_mean=float(drift.mean()), nav_err_m_max=float(drift.max()),
        repeat_path_m_mean=float(rep_path.mean()),
        wp_idx=rep.final.dispatch.idx.cpu().tolist(),
        n_wps=n_wps.cpu().tolist(),
        landmarks=teach.store.count.cpu().tolist())
    print("ours_campaign_metrics " + json.dumps(agg), flush=True)
    print("ours_main_path " + json.dumps(stats), flush=True)
    return stats, (data, teach, wps, n_wps), rep.final


def ours_profile_phase(shared, carry):
    """A short profiled window continuing the ours repeat: launches per
    tick and the device's busy share.  It runs after every timed phase: once
    the profiler has attached to the CUDA driver, launches stay slower for
    the rest of the process."""
    from nclt_slam_tpu_torch import config
    from nclt_slam_tpu_torch.rollout.repeat import run_repeat

    data, teach, wps, n_wps = shared
    launches, busy_s, wall = profile_window(lambda: run_repeat(
        data.scenes_repeat, data.routes, teach.teach_grid, wps, n_wps,
        config.ours(), PROFILE_TICKS, store=teach.store, carry=carry,
        tick0=executed(OURS_REPEAT_TICKS)))
    stats = dict(profiled_ticks=PROFILE_TICKS,
                 profiled_ms_per_tick=wall / PROFILE_TICKS * 1e3,
                 launches_per_tick=launches / PROFILE_TICKS,
                 device_busy_share=busy_s / wall)
    print("ours_profile " + json.dumps(stats), flush=True)
    return stats


def rgbd_ba_main_path_phase(shared, dev):
    """The 15-route ``rgbd_ba`` repeat (VIO without the inertial term,
    anchors, GT-stall watchdog, local BA every tenth tick) off the ours
    path's teach, then the same mode without the BA."""
    import numpy as np
    import torch
    from nclt_slam_tpu_torch.baselines import configs as baselines
    from nclt_slam_tpu_torch.rollout import campaign

    data, teach, wps, n_wps = shared
    n_routes = len(data.names)
    cfg = baselines.rgbd_ba()
    substeps = cfg.sim.nav_decimation
    torch.cuda.synchronize()

    reset_counts()
    with watch_local_ba(n_routes, dev) as tally:
        t0 = time.perf_counter()
        rep = campaign.run_campaign_repeat(
            data, teach.teach_grid, wps, n_wps, cfg, RGBD_BA_REPEAT_TICKS,
            stores=teach.store, stop_when_done=False)
        torch.cuda.synchronize()
        repeat_s = time.perf_counter() - t0
    counts = read_counts()

    rep_exec = executed(RGBD_BA_REPEAT_TICKS)
    k3_local = counts["k3_sites"].get("local_ba", 0)
    check(k3_local == rep_exec // BA_PERIOD and counts["k3"] == k3_local,
          f"the rgbd_ba path launched K3 {counts['k3_sites']} times in "
          f"{rep_exec} ticks, expected {rep_exec // BA_PERIOD} from local_ba")
    check(counts["k1_sites"].get("vio", 0) > 0
          and counts["k1_sites"].get("matcher", 0) > 0,
          f"the rgbd_ba path did not launch K1 at both sites: "
          f"{counts['k1_sites']}")
    check(counts["k2"] > 0, "the rgbd_ba path launched K2 no time")
    accepted = tally["accepted"].cpu().numpy()
    points = tally["points"].cpu().numpy()
    check(accepted.sum() > 0 and points.sum() > 0,
          f"no local-BA solve passed its gate: accepted {accepted.tolist()}, "
          f"points written {points.tolist()}")
    r = rep.trace
    traces_finite((("rgbd_ba gt_xy", r.gt_xy), ("rgbd_ba nav_xy", r.nav_xy),
                   ("rgbd_ba vio_xy", r.vio_xy), ("rgbd_ba cmd_v", r.cmd_v)))
    committed = rep.final.fusion.committed.cpu().numpy()
    check(committed.all(), f"rgbd_ba relays not committed: "
          f"{committed.tolist()}")
    rep_path = np.hypot(*np.diff(r.gt_xy, axis=1).T).sum(0)
    check((rep_path > 2.0).sum() >= n_routes - 2,
          f"rgbd_ba robots did not move: {rep_path.round(2).tolist()}")
    drift = np.hypot(*(r.nav_xy - r.gt_xy).transpose(2, 0, 1))

    # the same mode without the BA: the watchdog and use_imu=False paths
    plain_cfg = baselines.rgbd_no_imu()
    t0 = time.perf_counter()
    plain = campaign.run_campaign_repeat(
        data, teach.teach_grid, wps, n_wps, plain_cfg, RGBD_REPEAT_TICKS,
        stores=teach.store, stop_when_done=False)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    plain_exec = executed(RGBD_REPEAT_TICKS)
    check(read_counts()["k3"] == counts["k3"],
          "the rgbd repeat without local BA launched K3")
    traces_finite((("rgbd gt_xy", plain.trace.gt_xy),
                   ("rgbd nav_xy", plain.trace.nav_xy)))
    check(plain.final.fusion.committed.all().item(),
          "rgbd relays not committed")

    stats = dict(
        routes=n_routes, repeat_ticks=rep_exec, repeat_s=repeat_s,
        env_steps_per_s=rep_exec * substeps * n_routes / repeat_s,
        repeat_ms_per_tick=repeat_s / rep_exec * 1e3,
        launches=counts,
        local_ba_calls=tally["calls"],
        local_ba_accepted_per_route=accepted.tolist(),
        local_ba_points_written_per_route=points.tolist(),
        keyframes_per_route=rep.final.vio.kf_valid.sum(1).cpu().tolist(),
        anchors_published_per_route=r.anchor_ok.sum(1).tolist(),
        stalled_routes=int(r.done[:, -1].sum()),
        nav_err_m_mean=float(drift.mean()), nav_err_m_max=float(drift.max()),
        repeat_path_m_mean=float(rep_path.mean()),
        wp_idx=rep.final.dispatch.idx.cpu().tolist(),
        rgbd_repeat_ticks=plain_exec, rgbd_repeat_s=plain_s,
        rgbd_env_steps_per_s=plain_exec * substeps * n_routes / plain_s,
        rgbd_repeat_ms_per_tick=plain_s / plain_exec * 1e3)
    print("rgbd_ba_main_path " + json.dumps(stats), flush=True)
    return stats


def run() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on a GPU",
              file=sys.stderr)
        return 2
    csrc = REPO / "nclt_slam_tpu_torch" / "csrc"
    if not all((csrc / f).is_file() for f in
               ("wavefront.cu", "hamming.cu", "ba.cu", "gauss_jordan.cuh")):
        print(f"chip_smoke: no nclt_slam_tpu_torch checkout beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import nclt_slam_tpu_torch  # noqa: F401  (sets the TF32 switches)

    t_start = time.perf_counter()
    card = card_line()
    dev = torch.device("cuda", 0)
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, devices {torch.cuda.device_count()}, "
          f"tf32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"tf32 cudnn {torch.backends.cudnn.allow_tf32}", flush=True)
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")

    build_phase()
    k2_rows = kernel_phase(dev)
    k1_rows = hamming_phase(dev)
    k3 = ba_phase(dev)
    fixture_phase(dev)
    rgbd_ba_fixture_phase(ours_fixture_phase(dev), dev)
    gt = main_path_phase(dev)
    ours, shared, ours_carry = ours_main_path_phase(dev)
    rgbd_ba = rgbd_ba_main_path_phase(shared, dev)
    ours_profile_phase(shared, ours_carry)

    window, coarse = k2_rows
    vio_row, _, matcher_row = k1_rows
    k1_launches = ours["launches"]["k1"] + rgbd_ba["launches"]["k1"]
    k2_launches = gt["launches"]["k2"] + ours["launches"]["k2"] + \
        rgbd_ba["launches"]["k2"]
    kernels = {"kernels": [
        {
            "name": "hamming_cross_check",
            "route": "cuda",
            "source": "nclt_slam_tpu_torch/csrc/hamming.cu",
            "replaces": "nclt_slam_tpu/ops/hamming_pallas.py:62",
            "launches": k1_launches,
            "max_abs_err": max(row["max_abs_err"] for row in k1_rows),
            "ms": vio_row["ms"],
            "plain_ms": vio_row["plain_ms"],
            "bound_ms": vio_row["bound_ms"],
            "bound_by": vio_row["bound_by"],
            "library_ms": None,
            "shape": vio_row["shape"],
            "launches_by_path": {"ours": ours["launches"]["k1_sites"],
                                 "rgbd_ba": rgbd_ba["launches"]["k1_sites"]},
            "matcher_shape": matcher_row["shape"],
            "matcher_ms": matcher_row["ms"],
            "matcher_plain_ms": matcher_row["plain_ms"],
            "matcher_bound_ms": matcher_row["bound_ms"],
        },
        {
            "name": "wavefront_relax",
            "route": "cuda",
            "source": "nclt_slam_tpu_torch/csrc/wavefront.cu",
            "replaces": "nclt_slam_tpu/ops/wavefront_pallas.py:34",
            "launches": k2_launches,
            "max_abs_err": max(window["max_abs_err"], coarse["max_abs_err"]),
            "ms": window["ms"],
            "plain_ms": window["plain_ms"],
            "bound_ms": window["bound_ms"],
            "bound_by": window["bound_by"],
            "library_ms": None,
            "shape": window["shape"],
            "launches_by_path": {"gt": gt["launches"]["k2"],
                                 "ours": ours["launches"]["k2"],
                                 "rgbd_ba": rgbd_ba["launches"]["k2"]},
            "coarse_shape": coarse["shape"],
            "coarse_ms": coarse["ms"],
            "coarse_plain_ms": coarse["plain_ms"],
            "coarse_bound_ms": coarse["bound_ms"],
        },
        {
            "name": "solve_ba",
            "route": "cuda",
            "source": "nclt_slam_tpu_torch/csrc/ba.cu",
            "replaces": "nclt_slam_tpu/ops/ba_pallas.py:199",
            "launches": rgbd_ba["launches"]["k3"],
            "max_abs_err": max(row["max_abs_err"] for row in k3["checks"]),
            "ms": k3["rollout"]["ms"],
            "plain_ms": k3["rollout"]["plain_ms"],
            "bound_ms": k3["rollout"]["bound_ms"],
            "bound_by": k3["rollout"]["bound_by"],
            "library_ms": None,
            "shape": k3["rollout"]["shape"],
            "launches_by_site": rgbd_ba["launches"]["k3_sites"],
            "bench_shape": k3["bench"]["shape"],
            "bench_ms": k3["bench"]["ms"],
            "bench_plain_ms": k3["bench"]["plain_ms"],
            "bench_bound_ms": k3["bench"]["bound_ms"],
            "bench_solves_per_s": k3["bench"]["solves_per_s"],
            "sweep": k3["sweep"],
        }]}
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    try:
        return run()
    except SmokeError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
