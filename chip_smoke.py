#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``nclt_slam_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. print the card (``nvidia-smi`` name and power limit), torch/CUDA versions
   and the TF32 switches;
2. build the hand-written kernels from ``nclt_slam_tpu_torch/csrc`` with
   nvcc, one compiler process per source, all started together;
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
5. replay the JAX reference fixture of the GT-localized campaign
   (``tests/data/torch_gt_campaign_fixture.npz``: 2 routes at full width,
   100 teach + 100 repeat ticks) and compare within the tolerances below;
6. replay the JAX reference fixture of the ours campaign
   (``tests/data/torch_ours_campaign_fixture.npz``: 2 routes at full width,
   150 VIO-teach + 150 full-stack repeat ticks) and compare;
7. drive the GT-localized main path through the campaign API: 15 routes at
   full width, a GT teach, teach waypoints, a GT repeat with
   ``stop_when_done=False``; check that K2 was launched on it;
8. drive the ours main path through the campaign API: the 15-route
   campaign at full width, a VIO teach (``config.gt_localization()``), the
   aligned-VIO teach waypoints and a full-stack repeat (``config.ours()``:
   VIO + anchors + v55 fusion) with ``stop_when_done=False``; check that K1
   was launched at both call sites (VIO frame, anchor matcher) and K2 too,
   every trace is finite, every relay committed, an anchor was published
   and the robots moved; profile a short window for the launches per tick
   and the device's busy share.

Each main path runs with the kernels' launch counts set to 0 just before
it and read just after.  The last three lines are a JSON line of
per-kernel results, the card line, and ``{"ok": true, "device": {...}}``.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""

from __future__ import annotations

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

TEACH_TICKS = 500
REPEAT_TICKS = 300
OURS_TEACH_TICKS = 500
OURS_REPEAT_TICKS = 300
PROFILE_TICKS = 10
KERNEL_SHAPES = ((15, 192, 192), (15, 119, 232))
KERNEL_ITERS = 384
# K1 problems: (a-sets, A rows, b-sets, B rows), 8 words (256 bits) a row
HAMMING_SHAPES = ((15, 256, 15, 384), (75, 256, 75, 256), (75, 256, 15, 256))
DESC_WORDS = 8

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
    from nclt_slam_tpu_torch.ops import hamming as hm
    from nclt_slam_tpu_torch.ops import wavefront as wf
    wf.wavefront_relax.launches = 0
    hm.reset_launches()


def read_counts():
    from nclt_slam_tpu_torch.ops import hamming as hm
    from nclt_slam_tpu_torch.ops import wavefront as wf
    return dict(k2=wf.wavefront_relax.launches, k1=hm.cross_check.launches,
                k1_sites=dict(hm.cross_check.site_launches))


def build_phase():
    """Build every kernel, one nvcc per source, all at once."""
    from nclt_slam_tpu_torch.ops import hamming as hm
    from nclt_slam_tpu_torch.ops import wavefront as wf

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        libs = list(ex.map(lambda m: m.build_library(), (wf, hm)))
    wf._load()
    hm._load()
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
    from nclt_slam_tpu_torch.rollout.repeat import run_repeat

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

    # a short profiled window continuing the repeat
    launches, busy_s, wall = profile_window(lambda: run_repeat(
        data.scenes_repeat, data.routes, teach.teach_grid, wps, n_wps, cfg,
        PROFILE_TICKS, store=teach.store, carry=rep.final,
        tick0=executed(OURS_REPEAT_TICKS)))

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
        profiled_ticks=PROFILE_TICKS,
        profiled_ms_per_tick=wall / PROFILE_TICKS * 1e3,
        launches_per_tick=launches / PROFILE_TICKS,
        device_busy_share=busy_s / wall,
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
    return stats


def run() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on a GPU",
              file=sys.stderr)
        return 2
    csrc = REPO / "nclt_slam_tpu_torch" / "csrc"
    if not ((csrc / "wavefront.cu").is_file()
            and (csrc / "hamming.cu").is_file()):
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
    fixture_phase(dev)
    ours_fixture_phase(dev)
    gt = main_path_phase(dev)
    ours = ours_main_path_phase(dev)

    window, coarse = k2_rows
    vio_row, _, matcher_row = k1_rows
    k2_launches = gt["launches"]["k2"] + ours["launches"]["k2"]
    kernels = {"kernels": [
        {
            "name": "hamming_cross_check",
            "route": "cuda",
            "source": "nclt_slam_tpu_torch/csrc/hamming.cu",
            "replaces": "nclt_slam_tpu/ops/hamming_pallas.py:62",
            "launches": ours["launches"]["k1"],
            "max_abs_err": max(row["max_abs_err"] for row in k1_rows),
            "ms": vio_row["ms"],
            "plain_ms": vio_row["plain_ms"],
            "bound_ms": vio_row["bound_ms"],
            "bound_by": vio_row["bound_by"],
            "library_ms": None,
            "shape": vio_row["shape"],
            "launches_by_site": ours["launches"]["k1_sites"],
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
                                 "ours": ours["launches"]["k2"]},
            "coarse_shape": coarse["shape"],
            "coarse_ms": coarse["ms"],
            "coarse_plain_ms": coarse["plain_ms"],
            "coarse_bound_ms": coarse["bound_ms"],
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
