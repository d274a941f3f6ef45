#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``nclt_slam_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. print the card (``nvidia-smi`` name and power limit), torch/CUDA versions
   and the TF32 switches;
2. build the wavefront kernel (K2) from ``nclt_slam_tpu_torch/csrc`` with
   nvcc and print the build time;
3. hold K2 against its plain PyTorch version, bit for bit (``torch.equal``),
   at the planner's two shapes — (15, 192, 192) windows and the
   (15, 119, 232) coarse map, 384 iterations, random lethal cells — and time
   both with CUDA events;
4. replay the JAX reference fixture (``tests/data/
   torch_gt_campaign_fixture.npz``, written by ``tools/make_torch_fixture.py``
   with the JAX package: 2 routes at full width, 100 teach + 100 repeat
   ticks) on the card and compare the traces within the tolerances below;
5. drive the port's main path through the campaign API: build the 15-route
   campaign at full width, a GT-localized teach, teach waypoints, and a GT
   repeat with ``stop_when_done=False``; check that K2 was launched on that
   path, every trace is finite, the robots moved and reached waypoints;
   print the campaign metrics and the env steps/s (ticks x 20 substeps x
   15 routes / s).

The last two lines are a JSON line of per-kernel results and the card line;
the very last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or outside a checkout of the repository, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
FIXTURE = REPO / "tests" / "data" / "torch_gt_campaign_fixture.npz"

TEACH_TICKS = 500
REPEAT_TICKS = 300
KERNEL_SHAPES = ((15, 192, 192), (15, 119, 232))
KERNEL_ITERS = 384

# fixture tolerances (GPU vs the JAX CPU reference): float32 rounding of
# sin/cos/exp and fused multiply-adds differs per device, ~1e-6 m per tick;
# the bounds leave room for that to accumulate over 100 ticks, and every
# discrete outcome must agree
FIX_TEACH_ATOL_M = 1e-2
FIX_REPEAT_ATOL_M = 5e-2
FIX_OCC_MISMATCH_FRAC = 0.01
DIVERGE_M = 1e-4   # "divergence starts" at the first tick beyond this


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


def slice_config():
    from nclt_slam_tpu_torch import config
    base = config.gt_localization()
    return base.replace(teach=dataclasses.replace(base.teach, run_vio=False))


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
        rows.append(dict(shape=[B, H, W], max_abs_err=err, ms=ms,
                         plain_ms=plain_ms))
        print(f"K2 {B}x{H}x{W} x{KERNEL_ITERS}: equal to plain, "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
    return rows


def fixture_phase(dev):
    """Replay the JAX reference campaign (2 routes) and compare."""
    import numpy as np
    import torch
    from nclt_slam_tpu_torch.rollout import campaign

    fx = np.load(FIXTURE)
    names = [str(n) for n in fx["routes"]]
    n_teach = fx["teach_gt_xy"].shape[1]
    n_rep = fx["repeat_gt_xy"].shape[1]
    cfg = slice_config()
    data = campaign.build_campaign(names, cfg=cfg, device=dev)
    teach = campaign.run_campaign_teach(data, cfg, n_teach,
                                        stop_when_done=False)
    wps, n_wps = campaign.teach_waypoints(data, teach, cfg)
    rep = campaign.run_campaign_repeat(data, teach.teach_grid, wps, n_wps,
                                       cfg, n_rep, stop_when_done=False)

    def divergence(a, b):
        d = np.abs(a - b).max(-1).max(0)          # per tick, worst route
        over = np.flatnonzero(d > DIVERGE_M)
        return float(d.max()), (int(over[0]) if len(over) else None)

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


def main_path_phase(dev):
    """The 15-route GT-localized campaign through the campaign API."""
    import numpy as np
    import torch
    from nclt_slam_tpu_torch.ops import wavefront as wf
    from nclt_slam_tpu_torch.rollout import campaign

    cfg = slice_config()
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

    wf.wavefront_relax.launches = 0
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
    launches = wf.wavefront_relax.launches

    n_exec, chunk = campaign.planned_chunks(REPEAT_TICKS, 250)
    rep_exec = n_exec * chunk
    n_exec_t, chunk_t = campaign.planned_chunks(TEACH_TICKS, 250)
    teach_exec = n_exec_t * chunk_t
    substeps = cfg.sim.nav_decimation
    check(launches > 0, "the main path launched K2 no time")
    for name, arr in (("teach gt_xy", teach.trace.gt_xy),
                      ("teach gt_yaw", teach.trace.gt_yaw),
                      ("repeat gt_xy", rep.trace.gt_xy),
                      ("repeat nav_xy", rep.trace.nav_xy),
                      ("repeat cmd_v", rep.trace.cmd_v)):
        check(np.isfinite(arr).all(), f"{name} has non-finite values")
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
        k2_launches=launches,
        repeat_path_m_mean=float(rep_path.mean()),
        wp_idx=wp_idx.tolist(), n_wps=n_wps.cpu().tolist(),
        landmarks=teach.store.count.cpu().tolist())
    print("campaign_metrics " + json.dumps(agg), flush=True)
    print("main_path " + json.dumps(stats), flush=True)
    return stats


def run() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on a GPU",
              file=sys.stderr)
        return 2
    if not (REPO / "nclt_slam_tpu_torch" / "csrc" / "wavefront.cu").is_file():
        print(f"chip_smoke: no nclt_slam_tpu_torch checkout beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import nclt_slam_tpu_torch  # noqa: F401  (sets the TF32 switches)
    from nclt_slam_tpu_torch.ops import wavefront as wf

    card = card_line()
    dev = torch.device("cuda", 0)
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, devices {torch.cuda.device_count()}, "
          f"tf32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"tf32 cudnn {torch.backends.cudnn.allow_tf32}", flush=True)
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")

    t0 = time.perf_counter()
    lib = wf.build_library()
    wf._load()
    print(f"K2 built in {time.perf_counter() - t0:.2f} s: "
          f"{lib.relative_to(REPO)}", flush=True)

    krows = kernel_phase(dev)
    fixture_phase(dev)
    stats = main_path_phase(dev)

    window, coarse = krows
    kernels = {"kernels": [{
        "name": "wavefront_relax",
        "route": "cuda",
        "source": "nclt_slam_tpu_torch/csrc/wavefront.cu",
        "replaces": "nclt_slam_tpu/ops/wavefront_pallas.py:34",
        "launches": stats["k2_launches"],
        "max_abs_err": max(window["max_abs_err"], coarse["max_abs_err"]),
        "ms": window["ms"],
        "plain_ms": window["plain_ms"],
        "shape": window["shape"],
        "coarse_shape": coarse["shape"],
        "coarse_ms": coarse["ms"],
        "coarse_plain_ms": coarse["plain_ms"],
    }]}
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
