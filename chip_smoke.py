#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``nclt_slam_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. print the card (``nvidia-smi`` name and power limit), torch/CUDA versions
   and the TF32 switches;
2. build the four hand-written kernels from ``nclt_slam_tpu_torch/csrc``
   with nvcc, one compiler process per source, all started together;
3. hold the wavefront kernel (K2) against its plain PyTorch version, bit for
   bit (``torch.equal``) on each of 10 launches, at the planner's two
   shapes — (15, 192, 192) windows and the (15, 119, 232) coarse map, 384
   iterations, random lethal cells — print its plan (a cluster of 8 blocks
   a grid: band rows, halo depth, shared memory, the clusters the card
   holds at once) and time both with CUDA events;
4. hold the Hamming cross-check kernel (K1) against its plain version, bit
   for bit on all three outputs of each of 10 launches, at the main path's
   shapes — 15 problems of 256 live features x 384 VIO map points, 75
   problems of 256 x 256, the matcher's grouped form (75
   stored-feature sets, five per route, against their route's 15 live
   frames), and the RGB-D SLAM baseline's 139 odometry frame pairs and
   16 loop candidates of 256 x 256 — with ~20 % invalid rows, shared rows (ties) and one
   all-invalid problem; print its plan (a cluster of blocks a problem:
   band rows, owned columns, threads, shared memory, the clusters the card
   holds at once) and time it, its plain version and an empty kernel of
   the same launch shape (the launch floor);
5. hold the bundle-adjustment kernel (K3) against its plain version on
   consistent windows (observations are projections of true points, so both
   solvers reach one optimum) by tolerance, at four shapes up to the
   rollout's 15 windows x 16 keyframes x 192 landmarks x 3 iterations; both
   must reach the generator's truth; print its plan (a cluster of blocks a
   window: landmarks a rank and a chunk, keyframes a band, shared memory,
   the clusters the card holds at once) and time it from a CUDA graph,
   eagerly, beside an empty kernel of the same launch and the host cost a
   call, at the rollout's shape and, on the batch benchmark's random
   windows, at 64 x 16 x 192 x 8 iterations and the benchmark's sweep
   shapes (two launches bit-equal at each); beside them, as a side figure,
   ``torch.linalg.cholesky_ex`` + ``torch.cholesky_solve`` of the
   rollout's reduced systems;
5b. hold the pose-graph kernel (K4) against its plain version in float32
   and float64 by tolerance on four reduced graphs (the JAX package's
   two-lap test graph; the fused route's padded graph at the SLAM tool's
   shape, 130 poses and 64 loop slots; a graph with no valid loop; the
   padded graph of a 2000-pose session with 256 loop slots, 514 poses),
   two runs bit-equal; time it at the tool's shape beside 15 calls of
   ``torch.linalg.solve`` on its 390-unknown system, per Gauss-Newton
   iteration too;
5c. run the port's dense ``optimize_pose_graph`` (the path ``run_slam``
   takes below 400 poses) on the unreduced two-lap graph (240 poses, 4
   loops) twice on the card and hold the two results bit-equal;
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
8a. replay the JAX reference stock and encoder repeats
   (``tests/data/torch_{stock,encoder}_campaign_fixture.npz``: 150 ticks
   off the same teach) and compare with the ours replay's tolerances and
   rules: the stock repeat's projected waypoints, poses, VIO track, every
   discrete sequence (goal-blocked flags, plan failures, RPP recovery
   phases) and the follower's final state; the encoder repeat's dynamics
   and relay; then force the stock stack's stall branches, which the stock
   campaigns do not reach: the same two routes' stock repeat with the
   wheels pinned and route 1's spawn lethal in its teach map, 350 ticks;
   RPP's progress checker must enter recovery on route 0 (its entries in
   the trace equal to the controller's count) and the dispatcher must
   block route 1's goal;
8b. replay the JAX reference SLAM session
   (``tests/data/torch_slam_fixture.npz``: the SLAM tool's winter season cut
   to 401 scans x 128 points) through ``run_slam`` and compare: loop pairs
   and detector flags equal, the open chain up to its first ICP
   correspondence flip, each loop whose RANSAC stage matches JAX's by its
   accept flag and measurement and every other one through
   ``registration.refine_and_gate`` from JAX's recorded RANSAC result (an
   accept flag may differ only there, on at most a tenth of the
   candidates; where each such candidate leaves the port's CPU run is
   printed); hold K4 and the fused PGO on the fixture's own pose graph
   against JAX's;
8c. run the RGB-D SLAM baseline (``datasets/slam/rgbd_slam.py``) on the
   loop session of the JAX package's ``tests/test_rgbd_slam.py`` (72
   pillars, 140 frames, built on the card by the port's ``observe``) twice:
   the two runs bit-equal, each launching K1 twice (site ``rgbd_slam``);
   match counts and loop set against ``tests/data/
   torch_rgbd_slam_fixture.npz`` (where they differ, the frames whose
   observed rows differ from the fixture's and the pairs whose Kabsch
   starts tie below float32 resolution are printed; every count must be a
   tied start's, ``kabsch_ties``); ATE open and optimized;
9. drive the GT-localized main path through the campaign API: 15 routes at
   full width, a GT teach, teach waypoints, a GT repeat with
   ``stop_when_done=False``; check that K2 was launched on it;
9b. run the GT repeat twice more from that teach and config, 100 ticks
   each, and hold the two runs bit-equal: every trace, every tensor of the
   final state (the live log-odds grid, the inflated costmap window and the
   coarse potential among them) and the potential of every
   ``plan_window`` call (run-to-run determinism on K2's path, where
   ``integrate_depth`` sums with ``scatter_add_``);
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
11a. drive the stock Nav2 baseline and the encoder-only ablation off the
    same teach, waypoints and stores: 15-route repeats at full width
    through the calibration front end ``tools/torch_calibrate.run``; check
    that K2 was launched in both and K1 (site ``vio``) in stock only, every
    trace is finite, the robots moved, every stock relay committed and the
    RPP recovery entries in the trace match the controller's count; print
    ms a tick, env steps/s, launches per site, the campaign aggregate, the
    recovery entries and goal-blocked ticks;
11b. render the depth image at full width with ``CameraConfig.
    ray_terrain_tex`` off and on: terrain hits within the texture's height
    bound plus the march's quantization, hit or miss agreeing on all but a
    hundredth of the rays; both times;
11c. drive the LiDAR SLAM main path: the SLAM tool's winter session at full
    width (2000 scans x 1024 points) through ``run_slam``; check that K4 was
    launched exactly once, from the fused PGO, every pose is finite, a loop
    was accepted and the optimized ATE is no worse than the open one; print
    each stage's wall seconds, scans/s and the ladder row, and time the
    ICP's parts;
12. profile a short window of the ours repeat, and one full-width ICP, for
    the launches per tick (per ICP iteration), the device's busy share and
    K2's and K1's device time in the ours window (last, because the
    profiler slows every launch that follows it in the process).

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
SLAM_FIXTURE = REPO / "tests" / "data" / "torch_slam_fixture.npz"

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
K2_CHECK_LAUNCHES = 10
DETERMINISM_TICKS = 100
# K1 problems: (a-sets, A rows, b-sets, B rows), 8 words (256 bits) a row
HAMMING_SHAPES = ((15, 256, 15, 384), (75, 256, 75, 256), (75, 256, 15, 256),
                  (139, 256, 139, 256), (16, 256, 16, 256))
DESC_WORDS = 8
K1_CHECK_LAUNCHES = 10
K1_TIMED_LAUNCHES = 200
PGO_DETERMINISM_RUNS = 2
# K3 against its plain version on consistent windows: (windows, keyframes,
# landmarks, iterations, point prior weight or None, w_rel); the last is
# the rollout's call (one window a route, scalar w_rel, point prior)
BA_SHAPES = ((3, 6, 64, 10, None, 100.0), (1, 6, 40, 6, 50.0, 100.0),
             (2, 10, 48, 6, None, 100.0), (15, 16, 192, 3, 50.0, 10.0))
BA_ROLLOUT = BA_SHAPES[-1]
BA_BENCH = (64, 16, 192, 8)           # the batch benchmark's call
BA_SWEEP = ((64, 10, 48, 8), (64, 10, 128, 8), (32, 16, 256, 8),
            (8, 24, 512, 8))
# K3 and its plain version both solve the reduced system by an unpivoted
# Cholesky and differ in summation order only (the kernel sums a landmark
# slice a cluster rank, then the ranks): they agree by tolerance on
# consistent windows (the JAX package's tests/test_ba_pallas.py), not bit
# for bit
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

# The LiDAR SLAM main path: the winter season of tools/slam_scale_test.py at
# full width (2000 scans x 1024 points, a 20-scan local map, 15 ICP
# iterations), through run_slam
SLAM_SCANS, SLAM_PTS, SLAM_LAPS = 2000, 1024, 2.0
SLAM_KW = dict(loop_min_gap=SLAM_SCANS // 8, sc_thresh=0.35, max_loops=64,
               sc_max_range=50.0, local_map_scans=20, icp_iters=15)
# K4 against its plain version: (a) the two-lap graph of the JAX package's
# tests/test_pgo.py (240 poses, 4 valid + 2 invalid loops) host-reduced;
# (b) the fused route's padded reduction at the tool's shape (2000 poses,
# 64 loop slots of which 56 valid: Kr = 2 + 2 * 64 = 130, N = 390, the
# padded copies of the last pose included); (c) (a) with no valid loop,
# padded; (d) the padded reduction of a 2000-pose two-lap session with 256
# loop slots, 200 of them valid (Kr = 514, N = 1542: 49 panels of 32, the
# last one padded, and the panel in chunks).  The kernel's float32 blocked
# Cholesky without pivoting and the plain version's pivoted LU (in float32
# and in float64) agree by tolerance: the JAX package's own two reduced
# solvers differ by 6.5e-5 on (a) and its test allows 1e-2.
PGO_ITERS = 15
PGO_ATOL = 1e-3
PGO_TOOL_SHAPE = (2000, 64, 56)        # poses, loop slots, valid loops
PGO_LARGE_SHAPE = (2000, 256, 200, 4)   # and the loops' spacing
# Operations of one K4 iteration, counted from csrc/pgo.cu's arithmetic
# (a multiply, an add, a divide, a floor, a sine or cosine count one each),
# each product once: an edge's residual and Jacobians 20, its three
# distinct 3 x 3 blocks w A^T B 63 each (H_ji is H_ij's transpose), its two
# gradients w A^T r 21 each — the kernel evaluates an edge at both of its
# ends, the function needs it once; 9 a pose (damping, prior, update); and
# the least a dense direct solve of the SPD system takes (Cholesky N^3 / 3
# and two triangular solves 2 N^2, N = 3K).
OPS_PGO_EDGE = 20 + 3 * 63 + 2 * 21
OPS_PGO_POSE = 9
# The SLAM fixture (tests/data/torch_slam_fixture.npz: the same session cut
# to 401 scans x 128 points, JAX on the CPU).  ICP is a chain of argmins:
# two map points at nearly one distance can swap between two builds, and
# from that scan on the open chains differ (tests/test_torch_slam_slice.py;
# on the CPU at scan 95, a near-tie of the ninth iteration's neighbours).
# The open chain and RMSEs are held within FIX_SLAM_ATOL up to that first
# flip, which must come after FIX_SLAM_MIN_FLIP scans (a fault, not
# rounding, diverges at once); the loop pairs and the detector's flags
# equal.  The forest's FPFH descriptors are near-identical (alike trunks), so
# many points share one correspondence and an eighth of the RANSAC's 3-point
# samples have a cross-covariance of rank <= 1, whose Kabsch rotation is
# whatever the SVD routine returns (tools/torch_ransac_probe.py): where such
# a sample wins or loses the consensus, the RANSAC result, and with it the
# accept flag, differs between two SVD routines.  Each candidate whose RANSAC transform agrees
# with the one JAX recorded is held to JAX's accept flag and measurement
# (within FIX_SLAM_ATOL); each other one through the port's own second half
# of the registration (registration.refine_and_gate) from JAX's RANSAC
# result, which must give JAX's flag and measurement; an accept flag may
# differ from JAX's only on a candidate of the second kind, and on at most
# FIX_SLAM_MAX_FLIP_SHARE of the detected candidates (the share of loop
# measurements that tests/test_torch_slam_slice.py lets differ).
# The PGO on the fixture's own graph, and K4 on its reduced graph, within
# FIX_SLAM_ATOL of JAX's solutions.
FIX_SLAM_ATOL = 1e-3
FIX_SLAM_MAX_FLIP_SHARE = 0.1
FIX_SLAM_MIN_FLIP = 20


# The RGB-D SLAM baseline (datasets/slam/rgbd_slam.py) on the loop session
# of the JAX package's tests/test_rgbd_slam.py: 72 pillars on a ring of
# radius 14 m, a closed loop of 140 frames plus a revisit, the test's run
# arguments.  Held against tests/data/torch_rgbd_slam_fixture.npz (JAX on the
# CPU): the per-frame match counts and the loop set equal wherever the
# frames' observed rows (feature ids) are the fixture's, the poses within
# RGBD_SLAM_ATOL_M.
# The frame-to-frame Kabsch keeps the best of four 24-step power iterations
# on Horn's matrix.  Where another start's Rayleigh quotient lies within
# KABSCH_TIE_GAP (relative, in float64) of the best, float32 cannot tell
# them apart: the float32 Horn matrix sums up to 256 products, so its
# entries, and the quotients, carry ~sqrt(256) * 2**-24 ~ 2**-20 of
# rounding.  The start kept there follows the rounding of the sums (the JAX
# package's eager and jitted runs differ on such pairs too).  A pair's count
# may differ from the reference only where both counts are among its tied
# starts' (kabsch_ties), by one inlier, on at most RGBD_SLAM_MAX_FLIP_SHARE
# of the pairs (tests/test_torch_rgbd_slam.py).
RGBD_SLAM_FIXTURE = REPO / "tests" / "data" / "torch_rgbd_slam_fixture.npz"
RGBD_SLAM_FRAMES = 140
RGBD_SLAM_KW = dict(loop_min_gap=60, sig_thresh=0.08)
RGBD_SLAM_ATOL_M = 0.05
RGBD_SLAM_MAX_FLIP_SHARE = 0.1
KABSCH_TIE_GAP = 2.0 ** -20
# a float32 frame_rel_pose lies within this of the float64 pose of the tied
# start it kept (2.6e-6 at most over the session's 139 pairs, JAX's and the
# port's, on the CPU)
KABSCH_TIE_POSE_ATOL = 1e-5
# the stock and encoder campaigns off the ours teach, their fixture replays
BASELINE_REPEAT_TICKS = 300
STOCK_FIXTURE = REPO / "tests" / "data" / "torch_stock_campaign_fixture.npz"
ENCODER_FIXTURE = REPO / "tests" / "data" / \
    "torch_encoder_campaign_fixture.npz"
STOCK_DISCRETE = ("goal_blocked", "plan_fails", "recovery_phase")
# the forced stall: RPP's progress checker allows 30 s (300 ticks)
STALL_TICKS = 350
# CameraConfig.ray_terrain_tex: the baked texture is within this of the
# analytic field (tests/test_scene.py::test_terrain_tex_matches_analytic)
TEX_HEIGHT_BOUND_M = 0.02
TEX_HIT_AGREE_FRAC = 0.99


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


def time_cuda_graph(fn, reps, replays: int = 5):
    """Device ms a call of ``fn``: ``reps`` calls captured in one CUDA
    graph and replayed ``replays`` times between two events.  A replay
    issues the kernels without the host's Python, checks and ctypes call,
    so a kernel shorter than its wrapper's host cost is timed by the card
    (each launch still pays its own start and finish on the card).  Calls
    made during capture run no kernel and are not counted by ``fn``'s
    wrapper beyond the capture itself."""
    import torch
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * reps)
    del graph
    return ms


def reset_counts():
    from nclt_slam_tpu_torch.ops import ba as ops_ba
    from nclt_slam_tpu_torch.ops import hamming as hm
    from nclt_slam_tpu_torch.ops import pgo as ops_pgo
    from nclt_slam_tpu_torch.ops import wavefront as wf
    wf.wavefront_relax.launches = 0
    hm.reset_launches()
    ops_ba.reset_launches()
    ops_pgo.reset_launches()


def read_counts():
    from nclt_slam_tpu_torch.ops import ba as ops_ba
    from nclt_slam_tpu_torch.ops import hamming as hm
    from nclt_slam_tpu_torch.ops import pgo as ops_pgo
    from nclt_slam_tpu_torch.ops import wavefront as wf
    return dict(k2=wf.wavefront_relax.launches, k1=hm.cross_check.launches,
                k1_sites=dict(hm.cross_check.site_launches),
                k3=ops_ba.solve_ba_cuda.launches,
                k3_sites=dict(ops_ba.solve_ba_cuda.site_launches),
                k4=ops_pgo.optimize_pgo_cuda.launches,
                k4_sites=dict(ops_pgo.optimize_pgo_cuda.site_launches))


def build_phase():
    """Build every kernel, one nvcc per source, all at once."""
    from nclt_slam_tpu_torch.ops import ba as ops_ba
    from nclt_slam_tpu_torch.ops import hamming as hm
    from nclt_slam_tpu_torch.ops import pgo as ops_pgo
    from nclt_slam_tpu_torch.ops import wavefront as wf

    mods = (wf, hm, ops_ba, ops_pgo)
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
        ref = wf.wavefront_relax_plain(tc, phi0, KERNEL_ITERS)
        outs = [wf.wavefront_relax(tc, phi0, KERNEL_ITERS)
                for _ in range(K2_CHECK_LAUNCHES)]
        torch.cuda.synchronize()
        err = max((o - ref).abs().max().item() for o in outs)
        bad = [i for i, o in enumerate(outs) if not torch.equal(o, ref)]
        check(not bad, f"K2 differs from its plain version at {(B, H, W)} "
              f"on launches {bad} of {K2_CHECK_LAUNCHES}: max abs err {err}")
        check((ref < 1e8).float().mean().item() > 0.5,
              f"K2 at {(B, H, W)}: most cells unreachable")
        plan = wf._launch_shape(H, W)
        plan = dict(plan._asdict(), grid=plan.grid(B),
                    max_active_clusters=wf.max_active_clusters(H, W))
        check(plan["max_active_clusters"] >= B,
              f"K2 at {(B, H, W)}: the card holds "
              f"{plan['max_active_clusters']} clusters, fewer than {B}")
        ms = time_cuda(lambda: wf.wavefront_relax(tc, phi0, KERNEL_ITERS), 20)
        plain_ms = time_cuda(
            lambda: wf.wavefront_relax_plain(tc, phi0, KERNEL_ITERS), 3)
        # per Jacobi iteration and cell: 8 neighbour adds, 8 mins, the
        # diagonal multiply and the final min; tc and phi0 read once, the
        # potential written once
        b_ms, b_by = bound_ms(3 * B * H * W * 4,
                              18 * B * H * W * KERNEL_ITERS)
        rows.append(dict(shape=[B, H, W], max_abs_err=err, ms=ms,
                         ms_per_iter=ms / KERNEL_ITERS, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, plan=plan))
        print(f"K2 {B}x{H}x{W} x{KERNEL_ITERS}: {K2_CHECK_LAUNCHES} launches "
              f"equal to plain; plan: cluster {plan['cluster']}, band rows "
              f"{plan['band_rows']}, halo {plan['halo']}, "
              f"{plan['threads_x']}x{plan['threads_y']} threads x "
              f"{plan['rows']} rows, {plan['smem_bytes']} B shared, grid "
              f"{plan['grid']}, max active clusters "
              f"{plan['max_active_clusters']}; kernel {ms:.4f} ms "
              f"({ms / KERNEL_ITERS * 1e3:.3f} us an iteration), plain "
              f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
    return rows


def hamming_inputs(shape, dev, seed: int = 1):
    """K1's check inputs at (P, A, Q, B): random words, b rows shared with
    and near (one bit off) the a rows of their group's first problem (ties
    and matches), ~20 % invalid rows and one all-invalid problem."""
    import torch
    P, A, Q, B = shape
    W = DESC_WORDS
    grp = P // Q
    g = torch.Generator().manual_seed(seed)
    da = torch.randint(0, 2 ** 32, (P, A, W), generator=g)
    db = torch.randint(0, 2 ** 32, (Q, B, W), generator=g)
    n = min(A, B) // 2
    db[:, :n] = da[::grp, :n]                          # shared rows
    db[:, n:n + n // 2] = da[::grp, n:n + n // 2] ^ 4  # near ties
    va = torch.rand(P, A, generator=g) > 0.2
    vb = torch.rand(Q, B, generator=g) > 0.2
    va[P // 2] = False                                 # all invalid
    return [t.to(dev) for t in (da, va, db, vb)]


def hamming_phase(dev):
    """K1 against its plain version at the main path's shapes: each of
    K1_CHECK_LAUNCHES launches bit-equal, the plan and the clusters the
    card holds, the kernel's, the plain version's and the launch floor's
    times."""
    import torch
    from nclt_slam_tpu_torch.ops import hamming as hm

    rows = []
    for seed, (P, A, Q, B) in enumerate(HAMMING_SHAPES, 1):
        W = DESC_WORDS
        args = hamming_inputs((P, A, Q, B), dev, seed)
        ref = hm.cross_check_plain(*args)
        outs = [hm.cross_check(*args, site="check")
                for _ in range(K1_CHECK_LAUNCHES)]
        torch.cuda.synchronize()
        err = max((o.to(torch.int64) - r.to(torch.int64)).abs().max().item()
                  for out in outs for o, r in zip(out, ref))
        for i, out in enumerate(outs):
            for name, o, r in zip(("best_b", "matched", "best_d"), out, ref):
                check(torch.equal(o, r), f"K1 {name} differs from its plain "
                      f"version at {(P, A, Q, B)} on launch {i}")
        check(bool(ref[1].any()), f"K1 at {(P, A, Q, B)}: nothing matched")
        check(not ref[1][P // 2].any() and bool((ref[2][P // 2] == hm.BIG)
                                                .all()),
              f"K1 at {(P, A, Q, B)}: the all-invalid problem matched")
        plan = hm.plan(P, A, B)
        n_clusters = hm.max_active_clusters(plan)
        check(n_clusters >= 1, f"K1 at {(P, A, Q, B)}: the card holds no "
              f"cluster of the plan {plan}")
        plan = dict(plan._asdict(), grid=plan.grid(P),
                    max_active_clusters=n_clusters,
                    one_wave=n_clusters >= P)
        # the card's time from a CUDA graph of launches; eager back-to-back
        # calls are held by the wrapper's host cost (tens of microseconds)
        ms = time_cuda_graph(lambda: hm.cross_check(*args, site="check"),
                             K1_TIMED_LAUNCHES)
        floor_ms = time_cuda_graph(
            lambda: hm.empty_launch(P, hm.plan(P, A, B)), K1_TIMED_LAUNCHES)
        eager_ms = time_cuda(lambda: hm.cross_check(*args, site="check"),
                             K1_TIMED_LAUNCHES)
        plain_ms = time_cuda(lambda: hm.cross_check_plain(*args), 5)
        # one distance matrix: xor + popcount + add per word pair; the
        # descriptors (int64 words) and flags read once, two int32 and a
        # bool written per a-row
        b_ms, b_by = bound_ms(8 * W * (P * A + Q * B) + P * A + Q * B
                              + 9 * P * A, 3 * P * A * B * W)
        rows.append(dict(shape=[P, A, Q, B, W], max_abs_err=err, ms=ms,
                         eager_ms=eager_ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by,
                         launch_floor_ms=floor_ms, plan=plan,
                         matched=int(ref[1].sum())))
        print(f"K1 {P}x{A} vs {Q}x{B}, {W} words: {K1_CHECK_LAUNCHES} "
              f"launches equal to plain ({int(ref[1].sum())} matched); plan: "
              f"cluster {plan['cluster']}, band rows {plan['band_rows']} "
              f"(padded {plan['pad_rows']}), columns {B} (padded "
              f"{plan['pad_cols']}), "
              f"{plan['threads']} threads, {plan['smem_bytes']} B shared, "
              f"grid {plan['grid']}, max active clusters {n_clusters} "
              f"({'one wave' if plan['one_wave'] else 'more than one wave'}"
              f" for {P}); kernel {ms:.4f} ms (graph; eager calls "
              f"{eager_ms:.4f}), launch floor {floor_ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, bound {b_ms:.5f} ms ({b_by})",
              flush=True)
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


def host_us_per_call(fn, calls: int = 200) -> float:
    """Host microseconds a call of ``fn`` takes with no synchronisation:
    the checks, the plan, the allocations and the launch."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def library_cholesky_ms(prob, iters):
    """A side figure for K3's reduced solve: the ms of
    ``torch.linalg.cholesky_ex`` + ``torch.cholesky_solve`` on the reduced
    systems that ``solve_ba_plain`` forms on ``prob`` (one batch of B
    systems an iteration, ``iters`` of them), captured from its calls."""
    import torch
    from nclt_slam_tpu_torch import config
    from nclt_slam_tpu_torch.vio import ba

    systems = []
    chol, solve = torch.linalg.cholesky_ex, torch.cholesky_solve

    def keep_chol(S, *a, **k):
        systems.append([S.clone()])
        return chol(S, *a, **k)

    def keep_solve(b, L, *a, **k):
        systems[-1].append(b.clone())
        return solve(b, L, *a, **k)

    torch.linalg.cholesky_ex, torch.cholesky_solve = keep_chol, keep_solve
    try:
        ba.solve_ba_plain(prob, config.DEFAULT.camera, config.DEFAULT.vio,
                          iters=iters)
    finally:
        torch.linalg.cholesky_ex, torch.cholesky_solve = chol, solve
    check(len(systems) == iters, "K3 side figure: the plain version's "
          f"solves were not captured ({len(systems)} of {iters})")

    def run():
        for S, b in systems:
            L, _ = chol(S)
            solve(b, L)
    return time_cuda(run, 20)


def ba_phase(dev):
    """K3 against its plain version on consistent windows, then its times
    at the rollout's and the batch benchmark's shapes: from a CUDA graph,
    eagerly, the launch floor, the host cost a call, the plain version,
    the bound and the plan; beside them the library's Cholesky of the
    rollout's reduced systems."""
    import numpy as np
    import torch
    from nclt_slam_tpu_torch import config
    from nclt_slam_tpu_torch.ops import ba as ops_ba
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
        again = ba.solve_ba(prob, cam, vcfg, iters=iters, site="check")
        first = ba.solve_ba(prob, cam, vcfg, iters=1, site="check")
        torch.cuda.synchronize()
        check(all(torch.isfinite(x).all().item() for x in out),
              f"K3 {name}: non-finite output")
        check(all(torch.equal(a, b) for a, b in zip(out, again)),
              f"K3 {name}: two launches differ")
        check((out.final_cost <= first.final_cost).all().item(),
              f"K3 {name}: the cost rose over {iters} iterations")
        plan = ops_ba.plan(B, K, P)
        check(ops_ba.kernel_smem_bytes(plan, K) == plan.smem_bytes,
              f"K3 {name}: the plan's shared memory differs from the "
              "kernel's count")
        n_clusters = ops_ba.max_active_clusters(plan)
        check(n_clusters >= 1, f"K3 {name}: the card holds no cluster of "
              f"the plan {plan}")
        plan_row = dict(plan._asdict(), grid=plan.grid(B),
                        max_active_clusters=n_clusters,
                        one_wave=n_clusters >= B)
        # the card's time from a CUDA graph of launches; eager calls are
        # held by the wrapper's host cost where that is longer
        ms = time_cuda_graph(lambda: ba.solve_ba(prob, cam, vcfg, iters=iters,
                                                 site="check"), reps)
        eager_ms = time_cuda(lambda: ba.solve_ba(prob, cam, vcfg,
                                                 iters=iters, site="check"),
                             reps)
        floor_ms = time_cuda_graph(lambda: ops_ba.empty_launch(B, plan), reps)
        host_us = host_us_per_call(lambda: ba.solve_ba(
            prob, cam, vcfg, iters=iters, site="check"))
        plain_ms = time_cuda(lambda: ba.solve_ba_plain(prob, cam, vcfg,
                                                       iters=iters), 3)
        b_ms, b_by = ba_bound(prob, iters)
        dense_ms = ba_flops_per_iter(K, P) * iters * B / PEAK_OPS_PER_S * 1e3
        row = dict(shape=[B, K, P, iters], ms=ms, eager_ms=eager_ms,
                   launch_floor_ms=floor_ms, host_us_per_call=host_us,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   solves_per_s=B / ms * 1e3, plan=plan_row,
                   observed_frac=(prob.obs_w > 0).float().mean().item(),
                   dense_count_ms=dense_ms)
        print(f"K3 {name} {B}x{K}x{P} x{iters}: plan: cluster "
              f"{plan.cluster}, {plan.landmarks_per_rank} landmarks a rank "
              f"({plan.chunk} a chunk, Bs^T of {plan.kept} kept), "
              f"{plan.keyframes_per_rank} keyframes "
              f"a band, {plan.threads} threads, {plan.smem_bytes} B shared, "
              f"grid {plan.grid(B)}, max active clusters {n_clusters} "
              f"({'one wave' if plan_row['one_wave'] else 'more than one'}"
              f"); kernel {ms:.4f} ms (graph; eager calls {eager_ms:.4f}; "
              f"{row['solves_per_s']:.0f} solves/s), launch floor "
              f"{floor_ms:.4f} ms, {host_us:.1f} us host a call, plain "
              f"{plain_ms:.2f} ms, bound {b_ms:.5f} ms ({b_by}; "
              f"{row['observed_frac']:.2f} of the observations present; the "
              f"JAX benchmark's dense count gives {dense_ms:.4f} ms)",
              flush=True)
        return row

    B, K, P, iters, prior, w_rel = BA_ROLLOUT
    prob, _ = consistent_windows(range(B), dev, K=K, P=P, w_rel=w_rel,
                                 prior=prior)
    rollout = timed("rollout", prob, B, K, P, iters, 50)
    rollout["max_abs_err"] = rows[-1]["max_abs_err"]
    rollout["library_cholesky_ms"] = library_cholesky_ms(prob, iters)
    print(f"K3 side figure: torch.linalg.cholesky_ex + torch.cholesky_solve "
          f"of the rollout's {iters} reduced systems ({B} x {6 * K} x "
          f"{6 * K}): {rollout['library_cholesky_ms']:.4f} ms (the kernel's "
          f"whole solve {rollout['ms']:.4f} ms)", flush=True)
    B, K, P, iters = BA_BENCH
    bench = timed("bench", bench_windows(B, K, P, dev), B, K, P, iters, 20)
    sweep = [timed("sweep", bench_windows(B, K, P, dev), B, K, P, iters, 10)
             for B, K, P, iters in BA_SWEEP]
    return dict(checks=rows, rollout=rollout, bench=bench, sweep=sweep)


def two_lap_graph(K: int = 240, seed: int = 3, n_loops: int = 4,
                  n_slots: int | None = None, spacing: int = 30):
    """The two-lap pose graph of the JAX package's ``tests/test_pgo.py``
    (noisy, biased odometry around a circle of radius 20 m, exact loop
    measurements), as numpy with the same draws in the same order; loop e
    joins pose 5 + e * spacing to the one half the session later.  Returns
    (PoseGraph2D of numpy arrays, ground truth (K, 3))."""
    import numpy as np
    from nclt_slam_tpu_torch.datasets.slam.loop_closure import PoseGraph2D

    rng = np.random.RandomState(seed)
    th_gt = np.linspace(0, 4 * np.pi, K)
    gt = np.stack([20.0 * np.cos(th_gt), 20.0 * np.sin(th_gt),
                   th_gt + np.pi / 2], -1)
    odo = []
    for k in range(K - 1):
        c, s = np.cos(gt[k, 2]), np.sin(gt[k, 2])
        d = gt[k + 1, :2] - gt[k, :2]
        m = np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1],
                      gt[k + 1, 2] - gt[k, 2]])
        m[:2] += rng.normal(0, 0.02, 2) + 0.004
        m[2] += rng.normal(0, 0.002)
        odo.append(m)
    odo = np.asarray(odo, np.float32)
    poses = np.zeros((K, 3), np.float32)
    poses[0] = gt[0]
    for k in range(K - 1):
        c, s = np.cos(poses[k, 2]), np.sin(poses[k, 2])
        poses[k + 1] = (poses[k, 0] + c * odo[k, 0] - s * odo[k, 1],
                        poses[k, 1] + s * odo[k, 0] + c * odo[k, 1],
                        poses[k, 2] + odo[k, 2])
    L = n_loops + 2 if n_slots is None else n_slots
    li, lj = np.zeros(L, np.int32), np.zeros(L, np.int32)
    lv, lm = np.zeros(L, bool), np.zeros((L, 3), np.float32)
    for e in range(n_loops):
        i = 5 + e * spacing
        j = min(i + K // 2, K - 1)
        li[e], lj[e], lv[e] = i, j, True
        c, s = np.cos(gt[i, 2]), np.sin(gt[i, 2])
        d = gt[j, :2] - gt[i, :2]
        lm[e] = (c * d[0] + s * d[1], -s * d[0] + c * d[1],
                 gt[j, 2] - gt[i, 2])
    return PoseGraph2D(poses, odo, li, lj, lm, lv), gt


def pgo_graphs(dev):
    """K4's four check graphs on ``dev``: name -> (reduced PoseGraph2D,
    chain weights)."""
    import torch
    from nclt_slam_tpu_torch.datasets.slam import loop_closure as lc

    def on(graph):
        return lc.PoseGraph2D(*(torch.from_numpy(a).to(dev) for a in graph))

    two_lap = on(two_lap_graph()[0])
    K, L, V = PGO_TOOL_SHAPE
    tool = on(two_lap_graph(K=K, n_loops=V, n_slots=L, spacing=17)[0])
    none = two_lap._replace(loop_valid=torch.zeros_like(two_lap.loop_valid))
    K, L, V, spacing = PGO_LARGE_SHAPE
    large = on(two_lap_graph(K=K, n_loops=V, n_slots=L, spacing=spacing)[0])
    return {"two_lap": lc.reduce_pose_graph(two_lap, 1.0)[:2],
            "tool_shape": lc.reduce_pose_graph_padded(tool, 1.0)[:2],
            "no_valid_loop": lc.reduce_pose_graph_padded(none, 1.0)[:2],
            "large": lc.reduce_pose_graph_padded(large, 1.0)[:2]}


def pgo_bound(graph, iters):
    """(ms, what bounds it) for one K4 solve of ``graph``: every input read
    once, the poses written once, and the operations of csrc/pgo.cu's
    Gauss-Newton with the least dense direct solve (see OPS_PGO_EDGE)."""
    K, L = graph.poses.shape[0], graph.loop_i.shape[0]
    N = 3 * K
    n_edges = K - 1 + int(graph.loop_valid.sum())
    ops = (n_edges * OPS_PGO_EDGE + K * OPS_PGO_POSE
           + N ** 3 / 3 + 2 * N * N)
    n_bytes = 4 * (3 * K + 4 * (K - 1) + 6 * L) + 12 * K
    return bound_ms(n_bytes, ops * iters)


def pgo_phase(dev):
    """K4 against its plain version (float32 and float64) on graphs (a) to
    (d), two runs bit-equal; times at the tool's shape."""
    import torch
    from nclt_slam_tpu_torch.datasets.slam import loop_closure as lc

    graphs = pgo_graphs(dev)
    rows = {}
    for name, (graph, w) in graphs.items():
        out = lc.optimize_pgo(graph, w, iters=PGO_ITERS, site="check")
        again = lc.optimize_pgo(graph, w, iters=PGO_ITERS, site="check")
        ref32 = lc.optimize_pgo_plain(graph, w, iters=PGO_ITERS)
        g64 = graph._replace(poses=graph.poses.double(),
                             odo_meas=graph.odo_meas.double(),
                             loop_meas=graph.loop_meas.double())
        ref64 = lc.optimize_pgo_plain(g64, w.double(), iters=PGO_ITERS)
        torch.cuda.synchronize()
        check(torch.isfinite(out).all().item(), f"K4 {name}: non-finite")
        check(torch.equal(out, again), f"K4 {name}: two runs differ")
        e32 = (out - ref32).abs().max().item()
        e64 = (out.double() - ref64).abs().max().item()
        check(e32 <= PGO_ATOL and e64 <= PGO_ATOL,
              f"K4 differs from its plain version on {name}: {e32} "
              f"(float32), {e64} (float64) > {PGO_ATOL}")
        shape = [graph.poses.shape[0], graph.loop_i.shape[0],
                 int(graph.loop_valid.sum())]
        rows[name] = dict(shape=shape, max_abs_err=max(e32, e64),
                          err_plain_f32=e32, err_plain_f64=e64,
                          moved=(out - graph.poses).abs().max().item())
        print(f"K4 {name} (Kr, L, valid) {shape}: within tolerance of "
              f"plain (float32 {e32:.2e}, float64 {e64:.2e}), bit-equal "
              f"runs, poses moved up to {rows[name]['moved']:.3f}",
              flush=True)
    check(rows["no_valid_loop"]["moved"] < 0.05,
          "K4 moved the poses of a graph with no valid loop")

    graph, w = graphs["tool_shape"]
    ms = time_cuda(lambda: lc.optimize_pgo(graph, w, iters=PGO_ITERS,
                                           site="check"), 10)
    plain_ms = time_cuda(lambda: lc.optimize_pgo_plain(graph, w,
                                                       iters=PGO_ITERS), 3)
    ei, ej, meas, wts = lc._edges(graph, w, 10.0)
    H, g = lc._normal_equations(graph.poses, graph.poses[0], ei, ej, meas,
                                wts, 1e4, 1e-3, lc._wrap_floor)
    solve_ms = time_cuda(lambda: [torch.linalg.solve(H, g)
                                  for _ in range(PGO_ITERS)], 10)
    b_ms, b_by = pgo_bound(graph, PGO_ITERS)
    timed = dict(shape=rows["tool_shape"]["shape"], iters=PGO_ITERS, ms=ms,
                 plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                 linalg_solve_x15_ms=solve_ms,
                 ms_per_iter=ms / PGO_ITERS,
                 linalg_solve_ms=solve_ms / PGO_ITERS,
                 kernel_over_linalg_solve=ms / solve_ms)
    print(f"K4 tool shape {timed['shape']} x{PGO_ITERS}: kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, bound {b_ms:.5f} ms ({b_by}); "
          f"torch.linalg.solve of its {3 * graph.poses.shape[0]}-unknown "
          f"system x{PGO_ITERS}: {solve_ms:.3f} ms; a Gauss-Newton "
          f"iteration: kernel {ms / PGO_ITERS:.4f} ms, one "
          f"torch.linalg.solve {solve_ms / PGO_ITERS:.4f} ms, ratio "
          f"{ms / solve_ms:.3f}", flush=True)
    return dict(checks=rows, timed=timed)


def pgo_determinism_phase(dev):
    """The port's dense ``optimize_pose_graph`` (the path ``run_slam`` takes
    below 400 poses: normal equations assembled with
    ``index_put_(accumulate=True)`` and ``index_add_``) on the unreduced
    two-lap graph (240 poses, 4 loops), PGO_DETERMINISM_RUNS times on the
    card, every run bit-equal to the first."""
    import torch
    from nclt_slam_tpu_torch.datasets.slam import loop_closure as lc

    graph, gt = two_lap_graph()
    graph = lc.PoseGraph2D(*(torch.from_numpy(a).to(dev) for a in graph))
    runs = [lc.optimize_pose_graph(graph, iters=15)
            for _ in range(PGO_DETERMINISM_RUNS)]
    torch.cuda.synchronize()
    diffs = [i for i, r in enumerate(runs[1:], 1)
             if not torch.equal(r, runs[0])]
    gap = max((r - runs[0]).abs().max().item() for r in runs)
    check(torch.isfinite(runs[0]).all().item(), "dense PGO: non-finite")
    check(not diffs, f"dense PGO: runs {diffs} differ from the first by up "
          f"to {gap}")
    err = (runs[0][:, :2].cpu().double()
           - torch.from_numpy(gt[:, :2])).norm(dim=1).max().item()
    stats = dict(poses=graph.poses.shape[0], loops=int(graph.loop_valid.sum()),
                 runs=PGO_DETERMINISM_RUNS, bit_equal=True,
                 max_position_err_m=err)
    print("pgo_determinism: dense optimize_pose_graph bit-equal over "
          f"{PGO_DETERMINISM_RUNS} runs " + json.dumps(stats), flush=True)
    return stats


@contextlib.contextmanager
def keep_results(module, names):
    """While the block runs, each ``module.<name>`` records its first
    argument and its result in the yielded dict (``run_slam`` looks both
    names up at each call)."""
    seen = {}
    inner = {n: getattr(module, n) for n in names}

    def wrap(n):
        def f(*a, **kw):
            out = inner[n](*a, **kw)
            seen[n] = (a[0], out)
            return out
        return f

    for n in names:
        setattr(module, n, wrap(n))
    try:
        yield seen
    finally:
        for n in names:
            setattr(module, n, inner[n])


def rgbd_loop_session(dev, T: int = RGBD_SLAM_FRAMES, R: float = 14.0):
    """The loop session of the JAX package's tests/test_rgbd_slam.py,
    observed by the port's ``observe`` from the same threefry keys, all T
    frames in one batched call: (Observation with fields (T, K, ...), GT xy
    (T, 2) numpy)."""
    import numpy as np
    import torch
    from nclt_slam_tpu_torch import interop
    from nclt_slam_tpu_torch.config import DEFAULT
    from nclt_slam_tpu_torch.core import prng
    from nclt_slam_tpu_torch.sensors.features import (
        build_scene_features,
        observe,
    )

    rng = np.random.RandomState(6)
    N = 72
    ang = rng.uniform(0, 2 * np.pi, N)
    rad = R + rng.uniform(-6.0, 6.0, N)
    oxy = np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1).astype(
        np.float32)
    ovalid = np.ones(N, bool)
    feats = build_scene_features(oxy, np.full(N, 0.4, np.float32),
                                 np.zeros(N, np.float32),
                                 np.full(N, 6.0, np.float32), ovalid,
                                 DEFAULT.landmarks)
    feats = type(feats)(*(x[None].expand((T,) + x.shape) for x in
                          interop.from_numpy_tree(feats, dev)))
    th = np.linspace(0, 2 * np.pi * (1 + 45 / T), T)   # loop + revisit
    gt = np.stack([R * np.cos(th), R * np.sin(th)], -1)
    yaw = th + np.pi / 2
    key = prng.PRNGKey(3, dev)
    keys = []
    for _ in range(T):
        key, ko = prng.split(key).unbind(0)
        keys.append(ko)
    pos3 = torch.tensor(np.concatenate([gt, np.full((T, 1), 0.31)], 1),
                        dtype=torch.float32, device=dev)
    obs = observe(pos3, torch.tensor(yaw, dtype=torch.float32, device=dev),
                  feats, torch.ones(T, N, dtype=torch.bool, device=dev),
                  torch.stack(keys), DEFAULT.camera, DEFAULT.landmarks)
    return obs, gt


def kabsch_ties(obs, cam):
    """Per odometry pair of a stacked session (pair k at k - 1), what
    ``frame_rel_pose`` gives when each of its two Kabsch solves keeps any
    power-iteration start whose Rayleigh quotient is, in float64, within
    KABSCH_TIE_GAP of the best: the outcomes between which float32 rounding
    may choose, a list of (n_inliers, dx, dy, dyaw) a pair."""
    import torch
    from nclt_slam_tpu_torch.datasets.slam import rgbd_slam as rs
    from nclt_slam_tpu_torch.landmarks.matcher import (
        _horn_starts,
        _start_pose,
    )
    from nclt_slam_tpu_torch.sensors.features import _take, cross_check_match

    T = obs.desc.shape[0]
    a = rs._frames(obs, range(T - 1))
    b = rs._frames(obs, range(1, T))
    m, matched, _ = cross_check_match(b.desc, b.valid, a.desc, a.valid,
                                      return_dist=True, site="check")
    pa = _take(rs._body_points(a, cam), m).double()
    pb = rs._body_points(b, cam).double()
    w0 = matched.double()

    def tied_starts(w):
        V, q, mp, mq = _horn_starts(pb, pa, w)
        best = q.max(-1, keepdim=True).values
        tied = (best - q) <= KABSCH_TIE_GAP * best.abs()
        return [(tied[:, k], *_start_pose(V, torch.full(
            (T - 1,), k, device=pb.device), mp, mq)) for k in range(4)]

    outcomes = [[] for _ in range(T - 1)]
    for tie1, R1, t1 in tied_starts(w0):
        w1 = w0 * (rs._residual(pb, pa, R1, t1) < 0.5)
        for tie2, R2, t2 in tied_starts(w1):
            n = ((w0 > 0) & (rs._residual(pb, pa, R2, t2) < 0.3)).sum(-1)
            pose = torch.stack([t2[:, 0], t2[:, 1],
                                torch.atan2(R2[:, 1, 0], R2[:, 0, 0])], -1)
            for p in torch.nonzero(tie1 & tie2)[:, 0].tolist():
                outcomes[p].append((int(n[p]), *pose[p].tolist()))
    return outcomes


def tie_witnessed(outcomes, n, pose):
    """Whether one of a pair's ``kabsch_ties`` outcomes has the inlier count
    ``n`` and lies within KABSCH_TIE_POSE_ATOL of ``pose`` (dx, dy, dyaw)."""
    return any(o[0] == int(n) and max(abs(x - float(y)) for x, y in
                                      zip(o[1:], pose)) <= KABSCH_TIE_POSE_ATOL
               for o in outcomes)


def slam_tool():
    sys.path.insert(0, str(REPO / "tools"))
    import torch_slam_scale_test
    return torch_slam_scale_test


def rank_le_1(src, Q, corr_ok, picks):
    """For each 3-point RANSAC sample, whether its weighted cross-covariance
    (``_kabsch_weighted``'s H, in float64) has rank <= 1: two or three of
    its correspondences share one point, and the rotation is whatever the
    SVD routine returns."""
    import torch
    P3, Q3 = src[picks].double(), Q[picks].double()
    w = (corr_ok[picks].double() + 1e-3)[..., None]
    mp = (P3 * w).sum(1, keepdim=True) / w.sum(1, keepdim=True)
    mq = (Q3 * w).sum(1, keepdim=True) / w.sum(1, keepdim=True)
    sv = torch.linalg.svdvals(((P3 - mp) * w).transpose(1, 2) @ (Q3 - mq))
    return sv[:, 1] <= 1e-6 * sv[:, 0]


def registration_replay(fx, scans, valid, dev):
    """The registrations of the fixture's detected candidates on the card,
    against the RANSAC stage that JAX recorded for each (``run_slam``'s
    keys: ``PRNGKey(0)`` split once per candidate).  A candidate whose
    RANSAC transform here is within FIX_SLAM_ATOL of JAX's is "same"; for
    every other, ``refine_and_gate`` runs from JAX's RANSAC result and must
    reproduce JAX's accept flag and measurement, and the stage where the
    card first leaves the port's own CPU run of the same candidate is
    recorded: the FPFH features (beyond 1e-4), the feature correspondences,
    or the hypotheses (how many rotations differ, and how many of those
    come from a sample of rank <= 1)."""
    import numpy as np
    import torch
    from nclt_slam_tpu_torch.core import prng
    from nclt_slam_tpu_torch.datasets.slam import registration as reg

    def on(d, *arrays):
        return [torch.from_numpy(np.array(a)).to(d) for a in arrays]

    def ransac_gap(R0, t0, e):
        return max((R0.cpu() - torch.from_numpy(fx["ransac_R"][e]))
                   .abs().max().item(),
                   (t0.cpu() - torch.from_numpy(fx["ransac_t"][e]))
                   .abs().max().item())

    key = prng.PRNGKey(0, dev)
    same, differ, refined_bad, stages = [], [], [], {}
    for e in np.flatnonzero(fx["detected"]):
        key, k = prng.split(key).unbind(0)
        i, j = int(fx["loop_i"][e]), int(fx["loop_j"][e])
        args = on(dev, scans[j], valid[j], scans[i], valid[i])
        R0, t0, _, _ = reg.ransac_registration(*args, k)
        if ransac_gap(R0, t0, e) <= FIX_SLAM_ATOL:
            same.append(int(e))
            continue
        differ.append(int(e))
        res = reg.refine_and_gate(
            *args, *on(dev, fx["ransac_R"][e], fx["ransac_t"][e],
                       fx["ransac_n"][e], fx["ransac_ok"][e]))
        ok = bool(res.ok.item())
        R, t = res.R.cpu().numpy(), res.t.cpu().numpy()
        m = np.array([t[0], t[1], np.arctan2(R[1, 0], R[0, 0])])
        if ok != bool(fx["found"][e]) or (
                ok and np.abs(m - fx["loop_meas"][e]).max() > FIX_SLAM_ATOL):
            refined_bad.append(int(e))
        # where the card leaves the port's CPU run of this candidate
        cpu = on("cpu", scans[j], valid[j], scans[i], valid[i])
        f_gap = max((reg.fpfh(*args[m:m + 2]).cpu()
                     - reg.fpfh(*cpu[m:m + 2])).abs().max().item()
                    for m in (0, 2))
        runs = []
        for a, kk in ((args, k), (cpu, k.cpu())):
            corr, corr_ok = reg.fpfh_correspondences(*a)
            runs.append((corr.cpu(), corr_ok.cpu()) + tuple(
                x.cpu() for x in reg.ransac_hypotheses(
                    a[0], a[2][corr], corr_ok, kk)))
        (corr, corr_ok, Rs, ts, counts, _), \
            (corr_c, ok_c, Rs_c, ts_c, counts_c, picks) = runs
        h_differ = (Rs - Rs_c).abs().amax((1, 2)) > FIX_SLAM_ATOL
        degenerate = rank_le_1(cpu[0], cpu[2][corr_c], ok_c, picks)
        best, best_c = int(counts.argmax()), int(counts_c.argmax())
        stages[int(e)] = dict(
            stage="features" if f_gap > 1e-4 else "correspondences" if
            bool(((corr != corr_c) | (corr_ok != ok_c)).any()) else
            "hypotheses",
            fpfh_gap=f_gap,
            correspondences_differ=int(((corr != corr_c)
                                        | (corr_ok != ok_c)).sum()),
            hypotheses_differ=int(h_differ.sum()),
            of_them_rank_le_1=int((h_differ & degenerate).sum()),
            best_card_cpu=[best, best_c],
            best_rank_le_1=[bool(degenerate[best]), bool(degenerate[best_c])],
            cpu_ransac_is_jax=ransac_gap(Rs_c[best_c], ts_c[best_c], e)
            <= FIX_SLAM_ATOL)
    rows = stages.values()
    summary = dict(
        stages={n: sum(r["stage"] == n for r in rows) for n in
                ("features", "correspondences", "hypotheses")},
        hypotheses_differ=sum(r["hypotheses_differ"] for r in rows),
        of_them_rank_le_1=sum(r["of_them_rank_le_1"] for r in rows),
        best_rank_le_1_on_card=sum(r["best_rank_le_1"][0] for r in rows))
    return dict(ransac_same=same, ransac_differ=differ,
                refined_from_jax_ransac_differ=refined_bad,
                ransac_differ_summary=summary, ransac_differ_stage=stages)


def slam_fixture_phase(dev):
    """Replay the JAX reference SLAM session (401 scans x 128 points) on
    the card through run_slam and compare; K4 on the fixture's own graph."""
    import ast
    import numpy as np
    import torch
    from nclt_slam_tpu_torch.datasets.slam import loop_closure as lc
    from nclt_slam_tpu_torch.datasets.slam import pipeline

    tool = slam_tool()
    fx = np.load(SLAM_FIXTURE)
    T, P = int(fx["scans"]), int(fx["pts"])
    noise = dict(tool.SEASONS)[str(fx["season"])]
    check((int(fx["world_seed"]), int(fx["scan_seed"])) == (11, 17),
          "the SLAM fixture's seeds are not the tool's")
    scans, valid, odom, xy, km = tool.season_session(T, float(fx["laps"]),
                                                     P, noise)
    check(tool.slam_checksum(scans, valid, odom) == str(fx["checksum"]),
          "the regenerated SLAM session differs from the fixture's")
    kw = ast.literal_eval(str(fx["run_kw"]))
    with keep_results(pipeline, ("detect_loops_scalable",
                                 "optimize_pose_graph_fast")) as seen:
        out = pipeline.run_slam(scans, valid, odom_pred=odom, device=dev,
                                **kw)
    detected = seen["detect_loops_scalable"][1][2].cpu().numpy()
    graph = seen["optimize_pose_graph_fast"][0]
    li, lj, found = out["loops"]
    found_ref = fx["found"]
    meas = graph.loop_meas.cpu().numpy()
    gap = np.abs(meas - fx["loop_meas"]).max(1)
    reg = registration_replay(fx, scans, valid, dev)
    d_open = np.abs(out["poses_open"] - fx["poses_open"]).max(1)
    d_rmse = np.abs(out["rmses"] - fx["rmses"])
    over = np.flatnonzero((d_open > FIX_SLAM_ATOL) | (d_rmse > FIX_SLAM_ATOL))
    first_flip = int(over[0]) if len(over) else None
    held = first_flip if first_flip is not None else T

    # the PGO on the fixture's own graph (the fused route: one K4 launch),
    # and K4 on its host-reduced graph
    fgraph = pipeline.pose_graph(fx["poses_open"], fx["loop_i"],
                                 fx["loop_j"], fx["loop_meas"], found_ref,
                                 dev)
    before = read_counts()["k4_sites"].get("fused", 0)
    opt = lc.optimize_pose_graph_fast(fgraph, iters=PGO_ITERS)
    k4_fused = read_counts()["k4_sites"].get("fused", 0) - before
    reduced, red_w, junctions = lc.reduce_pose_graph(fgraph, 1.0)
    red = lc.optimize_pgo(reduced, red_w, iters=PGO_ITERS, site="check")
    torch.cuda.synchronize()
    opt_err = float(np.abs(opt.cpu().numpy() - fx["poses_optimized"]).max())
    red = red.cpu().numpy()
    red_dense_err = float(np.abs(red - fx["red_dense"]).max())
    red_k4_err = float(np.abs(red - fx["red_k4_interpret"]).max())
    report = dict(
        scans=T, pts=P, loops_detected=int(detected.sum()),
        loops_accepted=int(np.asarray(found).sum()),
        loops_accepted_ref=int(found_ref.sum()),
        loop_pairs_equal=bool(np.array_equal(li, fx["loop_i"])
                              and np.array_equal(lj, fx["loop_j"])),
        found_equal=bool(np.array_equal(found, found_ref)),
        detected_equal=bool(np.array_equal(detected, fx["detected"])),
        accept_flips=np.flatnonzero(found != found_ref).tolist(),
        loop_meas_beyond_atol=np.flatnonzero(
            found & found_ref & (gap > FIX_SLAM_ATOL)).tolist(),
        **reg,
        open_first_flip_scan=first_flip,
        open_max_err_before_flip=float(d_open[:held].max()),
        rmse_max_err_before_flip=float(d_rmse[:held].max()),
        open_max_err=float(d_open.max()),
        pgo_on_fixture_graph_max_err_m=opt_err, pgo_k4_fused_launches=k4_fused,
        junctions_equal=bool(np.array_equal(junctions, fx["junctions"])),
        k4_reduced_vs_jax_dense=red_dense_err,
        k4_reduced_vs_jax_interpret=red_k4_err,
        optimized_finite=bool(np.isfinite(out["poses_optimized"]).all()))
    print("slam_fixture " + json.dumps(report), flush=True)
    check(report["loop_pairs_equal"] and report["detected_equal"],
          "SLAM loop pairs or detector flags differ from the fixture")
    # every loop whose RANSAC stage agrees with JAX's is accepted alike and
    # measured within the tolerance; every other is held through the port's
    # refine_and_gate from JAX's own RANSAC result; a flag flips only there,
    # and on few candidates
    same = np.zeros_like(found_ref)
    same[reg["ransac_same"]] = True
    agree = (found == found_ref) & (~found_ref | (gap <= FIX_SLAM_ATOL))
    check(agree[same].all(), f"loops with JAX's RANSAC result differ in "
          f"their accept flag or measurement: "
          f"{np.flatnonzero(same & ~agree).tolist()}")
    check(not reg["refined_from_jax_ransac_differ"],
          f"refine_and_gate from JAX's RANSAC result differs from JAX's "
          f"registration: {reg['refined_from_jax_ransac_differ']}")
    flips = report["accept_flips"]
    check(set(flips) <= set(reg["ransac_differ"])
          and len(flips) <= FIX_SLAM_MAX_FLIP_SHARE * detected.sum(),
          f"accept flags differ from JAX's at {flips}: beyond the "
          f"candidates whose RANSAC differs {reg['ransac_differ']} or more "
          f"than {FIX_SLAM_MAX_FLIP_SHARE:.0%} of the {int(detected.sum())} "
          f"candidates")
    check(first_flip is None or first_flip >= FIX_SLAM_MIN_FLIP,
          f"the open chain left the fixture at scan {first_flip}")
    check(opt_err <= FIX_SLAM_ATOL and k4_fused == 1,
          f"the PGO on the fixture's graph is {opt_err} m from JAX's "
          f"({k4_fused} K4 launches)")
    check(report["junctions_equal"] and red_dense_err <= FIX_SLAM_ATOL
          and red_k4_err <= FIX_SLAM_ATOL,
          f"K4 on the fixture's reduced graph: {red_dense_err} / "
          f"{red_k4_err} from JAX's dense / interpret-mode solutions")
    check(report["optimized_finite"], "non-finite optimized poses")
    return report


def icp_cost(scans, valid, dev):
    """The ICP's parts at full width: the nearest-neighbour step of 1024
    points against a 20-scan (20,480-point) map, the weighted Kabsch with
    its 3 x 3 SVD (and whether that synchronizes the host), one whole
    15-iteration ICP."""
    import warnings
    import torch
    from nclt_slam_tpu_torch.datasets.slam import icp

    S = SLAM_KW["local_map_scans"]
    src = torch.from_numpy(scans[S]).to(dev)
    sv = torch.from_numpy(valid[S]).to(dev)
    dst = torch.from_numpy(scans[:S].reshape(-1, 3)).to(dev)
    dv = torch.from_numpy(valid[:S].reshape(-1)).to(dev)
    idx, dist = icp._nearest(src, dst, dv)
    w = (sv & (dist < 1.0)).float()
    nearest_ms = time_cuda(lambda: icp._nearest(src, dst, dv), 20)
    kabsch_ms = time_cuda(lambda: icp._kabsch_weighted(src, dst[idx], w), 50)
    icp_ms = time_cuda(lambda: icp.icp_point_to_point(
        src, sv, dst, dv, iters=SLAM_KW["icp_iters"]), 5)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            icp._kabsch_weighted(src, dst[idx], w)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(c.message) for c in caught)
    return dict(nearest_ms=nearest_ms, kabsch_ms=kabsch_ms,
                icp_15_iters_ms=icp_ms,
                icp_ms_per_iter=icp_ms / SLAM_KW["icp_iters"],
                kabsch_host_syncs=syncs)


def slam_main_path_phase(dev, card):
    """The winter session of the SLAM scale tool at full width through
    run_slam: K4 launched once, from the fused PGO."""
    import numpy as np
    import torch
    from nclt_slam_tpu_torch.datasets.slam import pipeline

    tool = slam_tool()
    name, noise = tool.SEASONS[0]
    t0 = time.perf_counter()
    scans, valid, odom, xy, km = tool.season_session(
        SLAM_SCANS, SLAM_LAPS, SLAM_PTS, noise)
    gen_s = time.perf_counter() - t0
    cost = icp_cost(scans, valid, dev)
    torch.cuda.synchronize()

    reset_counts()
    stage_s = {}
    t0 = time.perf_counter()
    out = pipeline.run_slam(scans, valid, odom_pred=odom, device=dev,
                            stage_s=stage_s, **SLAM_KW)
    wall = time.perf_counter() - t0
    counts = read_counts()

    row = tool.ladder_row(name, noise, out, xy, km, wall, card)
    check(counts["k4"] == 1 and counts["k4_sites"] == {"fused": 1},
          f"the SLAM path launched K4 {counts['k4_sites']}, expected once "
          f"from the fused PGO")
    check(np.isfinite(out["poses_open"]).all()
          and np.isfinite(out["poses_optimized"]).all(),
          "non-finite SLAM poses")
    check(row["loops_accepted"] >= 1, "the SLAM path accepted no loop")
    check(row["ate_optimized_m"] <= row["ate_open_m"],
          f"the optimized ATE {row['ate_optimized_m']} m is worse than the "
          f"open {row['ate_open_m']} m")
    stats = dict(row, scans=SLAM_SCANS, pts=SLAM_PTS, path_km=float(km),
                 session_generation_s=gen_s, launches=counts,
                 loops_detected_slots=len(out["loops"][0]), icp=cost)
    for k in pipeline.STAGES:
        print(f"slam stage {k}: {stage_s[k]:.3f} s", flush=True)
    print(f"slam: {SLAM_SCANS} scans in {wall:.2f} s, "
          f"{SLAM_SCANS / wall:.1f} scans/s ({card})", flush=True)
    print(f"| {name} | {noise['jitter']} | {noise['dropout']} | "
          f"{row['ate_open_m']:.3f} m | {row['ate_optimized_m']:.3f} m | "
          f"{row['loops_accepted']} | {row['icp_rmse_mean']:.4f} | "
          f"{wall:.1f} s |", flush=True)
    print("slam_main_path " + json.dumps(stats), flush=True)
    return stats


def slam_profile_phase(dev):
    """One full-width 15-iteration ICP under the profiler: kernel launches
    an ICP iteration and the device's busy share."""
    import torch
    from nclt_slam_tpu_torch.datasets.slam import icp

    tool = slam_tool()
    scans, valid, _, _, _ = tool.season_session(
        SLAM_KW["local_map_scans"] + 1, SLAM_LAPS, SLAM_PTS,
        tool.SEASONS[0][1])
    S = SLAM_KW["local_map_scans"]
    args = [torch.from_numpy(a).to(dev) for a in
            (scans[S], valid[S], scans[:S].reshape(-1, 3),
             valid[:S].reshape(-1))]
    iters = SLAM_KW["icp_iters"]
    launches, busy_s, wall = profile_window(
        lambda: icp.icp_point_to_point(*args, iters=iters))
    stats = dict(icp_iters=iters, launches_per_icp_iter=launches / iters,
                 profiled_ms=wall * 1e3, device_busy_share=busy_s / wall)
    print("slam_profile " + json.dumps(stats), flush=True)
    return stats


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


def baseline_fixture_phase(shared, dev):
    """Replay the JAX reference stock and encoder repeats (2 routes, 150
    ticks) off the ours fixture's teach and compare, with the ours replay's
    tolerances and divergence rules: the stock repeat's projected
    waypoints, GT and nav poses, VIO track, every discrete sequence (the
    dispatcher's goal-blocked flag and plan failures and the RPP recovery
    phase among them) and the follower's final state; the encoder repeat's
    dynamics and relay (no VIO: the nav pose is encoder + compass)."""
    import numpy as np
    from nclt_slam_tpu_torch import config
    from nclt_slam_tpu_torch.baselines import configs as baselines
    from nclt_slam_tpu_torch.fusion.relay import REGIME_ENCODER
    from nclt_slam_tpu_torch.rollout import campaign

    data, teach, wps, n_wps = shared
    reports = {}
    for mode, path, cfg in (("stock", STOCK_FIXTURE, baselines.stock_nav2()),
                            ("encoder", ENCODER_FIXTURE,
                             config.encoder_only())):
        fx = np.load(path)
        check([str(n) for n in fx["routes"]] == list(data.names),
              f"the {mode} fixture's routes are not the ours fixture's")
        n_rep = fx["repeat_gt_xy"].shape[1]
        run_wps, run_n = campaign.apply_stock_projection(
            teach.teach_grid, wps, n_wps, cfg)
        rep = campaign.run_campaign_repeat(data, teach.teach_grid, wps,
                                           n_wps, cfg, n_rep,
                                           stores=teach.store,
                                           stop_when_done=False)
        r = rep.trace
        n_ref = int(fx["run_n_wps"].max())
        r_err, r_start = divergence(r.gt_xy, fx["repeat_gt_xy"])
        n_err, n_start = divergence(r.nav_xy, fx["repeat_nav_xy"])
        v_err, v_start = divergence(r.vio_xy, fx["repeat_vio_xy"])
        ctrl = {f: getattr(rep.final.ctrl, f).cpu().numpy()
                for f in rep.final.ctrl._fields}
        ctrl_equal = {f: bool(np.array_equal(v, fx[f"final_ctrl_{f}"]))
                      for f, v in ctrl.items() if v.dtype.kind != "f"}
        report = dict(
            routes=list(data.names), repeat_ticks=n_rep,
            run_n_wps=run_n.cpu().tolist(),
            run_n_wps_ref=fx["run_n_wps"].tolist(),
            run_wps_max_err_m=float(np.abs(
                run_wps.cpu().numpy()[:, :n_ref]
                - fx["run_wps"][:, :n_ref]).max()),
            repeat_gt_xy_max_err_m=r_err, repeat_divergence_from_tick=r_start,
            repeat_nav_xy_max_err_m=n_err,
            repeat_nav_divergence_from_tick=n_start,
            repeat_vio_xy_max_err_m=v_err,
            repeat_vio_divergence_from_tick=v_start,
            committed=rep.final.fusion.committed.cpu().tolist(),
            committed_ref=fx["repeat_committed"].tolist(),
            final_ctrl_equal=ctrl_equal,
            recovery_entries=int(ctrl.get("recovery_count",
                                          np.zeros(1)).sum()),
            goal_blocked_ticks=int(r.goal_blocked.sum()))
        for f in OURS_DISCRETE + STOCK_DISCRETE:
            report[f"{f}_first_diff"] = first_diff(getattr(r, f),
                                                   fx[f"repeat_{f}"])
        print(f"{mode}_fixture " + json.dumps(report), flush=True)
        check(report["run_n_wps"] == report["run_n_wps_ref"]
              and report["run_wps_max_err_m"] <= FIX_VIO_ATOL_M,
              f"{mode}: the projected waypoints differ from the fixture")
        check(r_err <= FIX_REPEAT_ATOL_M, f"{mode} repeat diverged from the "
              f"JAX fixture ({r_err} m)")
        check(n_err <= FIX_NAV_ATOL_M, f"{mode} nav pose diverged from the "
              f"JAX fixture ({n_err} m > {FIX_NAV_ATOL_M} m)")
        check(v_err <= FIX_NAV_ATOL_M, f"{mode} VIO track diverged from the "
              f"JAX fixture ({v_err} m > {FIX_NAV_ATOL_M} m)")
        check(report["committed"] == report["committed_ref"],
              f"{mode} relay commit differs from the fixture")
        check(all(ctrl_equal.values()), f"{mode}: the follower's final "
              f"state differs from the fixture: {ctrl_equal}")
        for f in OURS_DISCRETE + STOCK_DISCRETE:
            check(report[f"{f}_first_diff"] is None,
                  f"{mode} repeat {f} sequence differs from the fixture "
                  f"from tick {report[f'{f}_first_diff']}")
        if mode == "encoder":
            check(bool((r.regime == REGIME_ENCODER).all())
                  and not r.vio_xy.any(), "the encoder replay is not pure "
                  "dead reckoning")
        reports[mode] = report
    return reports


def rgbd_slam_phase(dev):
    """The RGB-D SLAM baseline on the loop session of the JAX package's
    tests/test_rgbd_slam.py, built on the card by the port's ``observe``:
    two runs bit-equal, each launching K1 twice (the batched odometry pairs
    and the batched loop candidates, site ``rgbd_slam``); the match counts
    and the loop set held against the JAX fixture (a difference allowed
    only on a frame whose observed rows differ from the fixture's, or by
    one inlier on a pair whose Horn iteration leaves its start choice to
    rounding); the JAX test's ATE checks."""
    import numpy as np
    import torch
    from nclt_slam_tpu_torch.config import DEFAULT
    from nclt_slam_tpu_torch.datasets.slam import rgbd_slam
    from nclt_slam_tpu_torch.eval.metrics import ate_rmse

    fx = np.load(RGBD_SLAM_FIXTURE)
    cam = DEFAULT.camera
    t0 = time.perf_counter()
    obs, gt = rgbd_loop_session(dev)
    torch.cuda.synchronize()
    session_s = time.perf_counter() - t0
    runs = []
    for _ in range(2):
        reset_counts()
        t0 = time.perf_counter()
        res = rgbd_slam.run_rgbd_slam(obs, cam, **RGBD_SLAM_KW)
        torch.cuda.synchronize()
        runs.append((res, time.perf_counter() - t0, read_counts()))
    (a, _, ca), (b, wall, cb) = runs
    T = len(a.n_matches)
    for c in (ca, cb):
        check(c["k1_sites"].get("rgbd_slam", 0) == 2 and c["k1"] == 2
              and c["k2"] == c["k3"] == c["k4"] == 0,
              f"run_rgbd_slam launched {c} (K1 twice at site rgbd_slam "
              f"expected)")
    same = all(same_bits(x, y) for x, y in
               [(a.poses_open, b.poses_open), (a.poses_opt, b.poses_opt),
                (a.n_matches, b.n_matches)] + list(zip(a.loops, b.loops)))
    check(same, "two RGB-D SLAM runs on the card differ")

    ids, valid = obs.feat_id.cpu().numpy(), obs.valid.cpu().numpy()
    rows_differ = np.flatnonzero(((ids != fx["feat_id"])
                                  | (valid != fx["valid"])).any(1))
    touched = set(rows_differ.tolist())
    ties = [{o[0] for o in x} for x in kabsch_ties(obs, cam)]
    unwitnessed = [k for k in range(1, T)
                   if int(b.n_matches[k]) not in ties[k - 1]]
    flips = np.flatnonzero(b.n_matches != fx["n_matches"])
    tie_flips = [int(k) for k in flips
                 if k - 1 not in touched and k not in touched]
    bad = [k for k in tie_flips
           if abs(int(b.n_matches[k]) - int(fx["n_matches"][k])) > 1
           or not {int(b.n_matches[k]), int(fx["n_matches"][k])}
           <= ties[k - 1]]
    got_loops = set(zip(*(x.tolist() for x in b.loops)))
    ref_loops = set(zip(fx["loop_i"].tolist(), fx["loop_j"].tolist(),
                        fx["loop_accepted"].tolist()))
    loop_diff = got_loops ^ ref_loops
    loop_bad = [e for e in loop_diff if e[0] not in touched
                and e[1] not in touched]
    open_err = float(np.abs(b.poses_open - fx["poses_open"]).max())
    opt_err = float(np.abs(b.poses_opt - fx["poses_opt"]).max())
    ate_open = ate_rmse(b.poses_open[:, :2], gt)
    ate_opt = ate_rmse(b.poses_opt[:, :2], gt)
    report = dict(
        frames=T, session_s=session_s, run_ms=wall * 1e3,
        frames_per_s=T / wall, k1_launches_rgbd_slam=cb["k1_sites"]
        .get("rgbd_slam", 0), two_runs_bit_equal=same,
        frames_with_rows_differing=rows_differ.tolist(),
        n_matches_differ_at=flips.tolist(),
        kabsch_tie_pairs=tie_flips,
        pairs_with_tied_counts=sum(len(c) > 1 for c in ties),
        counts_outside_tied_starts=unwitnessed,
        loops_accepted=int(b.loops[2].sum()),
        loops_accepted_ref=int(fx["loop_accepted"].sum()),
        loops_differing=sorted(loop_diff),
        poses_open_max_err_m=open_err, poses_opt_max_err_m=opt_err,
        ate_open_m=ate_open, ate_opt_m=ate_opt)
    print("rgbd_slam " + json.dumps(report), flush=True)
    check(not bad, f"RGB-D SLAM match counts differ from the fixture on "
          f"pairs {bad} (not a row-order difference or a Kabsch tie)")
    check(not unwitnessed, f"RGB-D SLAM match counts on pairs {unwitnessed} "
          f"are no tied Kabsch start's")
    check(len(tie_flips) <= RGBD_SLAM_MAX_FLIP_SHARE * (T - 1),
          f"RGB-D SLAM match counts differ on {len(tie_flips)} pairs")
    check(not loop_bad, f"RGB-D SLAM loops differ from the fixture: "
          f"{sorted(loop_bad)}")
    if not touched:
        check(open_err <= RGBD_SLAM_ATOL_M and opt_err <= RGBD_SLAM_ATOL_M,
              f"RGB-D SLAM poses differ from the fixture by {open_err} / "
              f"{opt_err} m")
    check((b.n_matches[1:] >= 8).mean() > 0.9 and b.loops[2].sum() >= 1,
          "RGB-D SLAM lost track or closed no loop")
    check(np.isfinite(ate_opt) and ate_opt <= ate_open * 1.05 + 0.02
          and ate_opt < 5.0, f"RGB-D SLAM ATE {ate_open} -> {ate_opt} m")
    return report


def terrain_tex_phase(shared, carry):
    """``render_depth`` at full width (the routes' poses at the end of the
    ours repeat, 80 x 60 rays) with ``CameraConfig.ray_terrain_tex`` off
    and on.  On the rays that hit the terrain both ways, the hit points'
    vertical gap stays within the texture's height bound plus the march's
    quantization (half a coarse and half a fine step of the altitude band);
    hit or miss and the depth image's valid mask agree on all but a
    hundredth of the rays."""
    import dataclasses as dc
    import torch
    from nclt_slam_tpu_torch.config import DEFAULT
    from nclt_slam_tpu_torch.dynamics.diffdrive import robot_pose3d
    from nclt_slam_tpu_torch.sensors import depth

    sc = shared[0].scenes_repeat
    pos3, _ = robot_pose3d(carry.robot)
    yaw = carry.robot.yaw
    cams = {flag: dc.replace(DEFAULT.camera, ray_terrain_tex=flag)
            for flag in (False, True)}
    out, ms = {}, {}
    for flag, cam in cams.items():
        out[flag] = depth.render_depth(pos3, yaw, sc.xy, sc.radius,
                                       sc.base_z, sc.height, sc.valid, cam)
        ms[flag] = time_cuda(lambda cam=cam: depth.render_depth(
            pos3, yaw, sc.xy, sc.radius, sc.base_z, sc.height, sc.valid,
            cam), 20)
    cam = cams[False]
    origin, R = depth.camera_pose(pos3, yaw, cam)
    dirs = depth._rotate(R, depth.ray_grid(cam, pos3.device)[None])
    t_off = depth._terrain_hit(origin, dirs, cams[False])
    t_on = depth._terrain_hit(origin, dirs, cams[True])
    both = torch.isfinite(t_off) & torch.isfinite(t_on)
    hit_agree = (torch.isfinite(t_off) == torch.isfinite(t_on)).float() \
        .mean().item()
    gap = ((t_on - t_off).abs() * dirs[..., 2].abs())[both]
    step_c = (depth._TERR_Z_MAX - depth._TERR_Z_MIN) / \
        max(8, cam.ray_steps // 4)
    bound = TEX_HEIGHT_BOUND_M + 0.5 * (step_c + step_c / 8)
    (d0, _, v0), (d1, _, v1) = out[False], out[True]
    valid_agree = (v0 == v1).float().mean().item()
    dd = (d1 - d0).abs()[v0 & v1]
    report = dict(
        rays=int(t_off.numel()), terrain_hits=int(both.sum()),
        hit_agree_frac=hit_agree,
        vertical_gap_max_m=gap.max().item(),
        vertical_gap_p99_m=gap.quantile(0.99).item(), bound_m=bound,
        valid_agree_frac=valid_agree, depth_diff_max_m=dd.max().item(),
        depth_diff_median_m=dd.median().item(),
        render_ms_analytic=ms[False], render_ms_tex=ms[True])
    print("terrain_tex " + json.dumps(report), flush=True)
    check(int(both.sum()) > 0, "no ray hit the terrain")
    check(hit_agree >= TEX_HIT_AGREE_FRAC
          and valid_agree >= TEX_HIT_AGREE_FRAC,
          f"ray_terrain_tex changes hit or miss on {1 - hit_agree} of the "
          f"rays ({1 - valid_agree} of the depth image)")
    check(gap.max().item() <= bound, f"ray_terrain_tex moves a terrain hit "
          f"{gap.max().item()} m vertically (bound {bound} m)")
    return report


def stock_stall_phase(shared, dev):
    """The stock stack's stall branches, which the stock campaigns (whose
    robots keep moving) do not reach, on the card: the stock repeat of the
    fixture's two routes for STALL_TICKS ticks with the wheels pinned
    (``SimConfig.max_wheel_speed`` 0) and route 1's spawn made lethal in its
    teach map.  Route 0 keeps its path and stalls, so RPP's progress checker
    (0.3 m in 30 s) must enter its recovery cycle, the trace's recovery
    phases agreeing with the controller's count; route 1's start is lethal,
    so the stock dispatcher must block its goal and clear its path."""
    import dataclasses as dc
    import numpy as np
    import torch
    from nclt_slam_tpu_torch.baselines import configs as baselines
    from nclt_slam_tpu_torch.control.rpp import PHASE_SPIN
    from nclt_slam_tpu_torch.mapping.occupancy import world_to_cell
    from nclt_slam_tpu_torch.rollout import campaign

    data, teach, wps, n_wps = shared
    base = baselines.stock_nav2()
    cfg = base.replace(sim=dc.replace(base.sim, max_wheel_speed=0.0))
    grid = teach.teach_grid.clone()
    r, c = (int(i) for i in world_to_cell(data.routes.spawn[1, 0],
                                          data.routes.spawn[1, 1], cfg.map))
    grid[1, r - 1:r + 2, c - 1:c + 2] = 2               # occupied
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = campaign.run_campaign_repeat(data, grid, wps, n_wps, cfg,
                                       STALL_TICKS, stores=teach.store,
                                       stop_when_done=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tr = rep.trace
    rp = np.asarray(tr.recovery_phase)
    entries = ((rp[:, 1:] > 0) & (rp[:, :-1] == 0)).sum(1) + (rp[:, 0] > 0)
    count = rep.final.ctrl.recovery_count.cpu().numpy()
    blocked = np.asarray(tr.goal_blocked).sum(1)
    moved = np.hypot(*(tr.gt_xy[:, -1] - tr.gt_xy[:, 0]).T)
    has_path = rep.final.dispatch.has_path.cpu().tolist()
    report = dict(
        routes=list(data.names), ticks=int(rp.shape[1]), wall_s=wall,
        recovery_entries=entries.tolist(), recovery_count=count.tolist(),
        first_recovery_tick=[int(np.argmax(x > 0)) if x.any() else None
                             for x in rp],
        recovery_phases_seen=sorted(set(rp[0].tolist())),
        goal_blocked_ticks=blocked.tolist(), final_has_path=has_path,
        moved_m=moved.tolist())
    print("stock_stall " + json.dumps(report), flush=True)
    traces_finite((("stall gt_xy", tr.gt_xy), ("stall nav_xy", tr.nav_xy),
                   ("stall cmd_v", tr.cmd_v)))
    check((moved < 0.05).all(), f"pinned robots moved {moved.tolist()} m")
    check(np.array_equal(entries, count), f"RPP recovery entries in the "
          f"trace {entries.tolist()} disagree with the controller's count "
          f"{count.tolist()}")
    check(count[0] >= 1 and PHASE_SPIN in report["recovery_phases_seen"],
          "the stalled route never entered RPP recovery")
    check(blocked[1] > 0 and not has_path[1], "the stock dispatcher did not "
          "block the goal of the route whose start is lethal")
    return report


def baseline_main_path_phase(shared, dev):
    """The 15-route stock and encoder repeats at full width off the ours
    path's teach, waypoints and landmark stores, through the calibration
    front end (``tools/torch_calibrate.run``): K2 launched in both, K1
    (site ``vio``) in stock only; traces finite and robots moving; every
    stock relay committed; the encoder's nav pose pure dead reckoning."""
    import numpy as np
    import torch
    sys.path.insert(0, str(REPO / "tools"))
    import torch_calibrate
    from nclt_slam_tpu_torch.fusion.relay import REGIME_ENCODER

    n_routes = len(shared[0].names)
    stats = {}
    for mode in ("stock", "encoder"):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        (_, _, agg, _, anchor), _, rep = torch_calibrate.run(
            None, mode, 0, BASELINE_REPEAT_TICKS, dev, shared=shared)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        sites = counts["k1_sites"]
        check(counts["k2"] > 0, f"the {mode} path launched K2 no time")
        check(counts["k3"] == counts["k4"] == 0
              and sites.get("matcher", 0) == 0,
              f"the {mode} path launched {counts}")
        if mode == "stock":
            check(sites.get("vio", 0) > 0 and counts["k1"] == sites["vio"],
                  f"the stock path did not launch K1 in vio_frame only: "
                  f"{sites}")
        else:
            check(counts["k1"] == 0, f"the encoder path launched K1: {sites}")
        r = rep.trace
        traces_finite(((f"{mode} gt_xy", r.gt_xy),
                       (f"{mode} nav_xy", r.nav_xy),
                       (f"{mode} vio_xy", r.vio_xy),
                       (f"{mode} cmd_v", r.cmd_v)))
        rep_path = np.hypot(*np.diff(r.gt_xy, axis=1).T).sum(0)
        check((rep_path > 2.0).sum() >= n_routes - 2,
              f"{mode} robots did not move: {rep_path.round(2).tolist()}")
        ex = executed(BASELINE_REPEAT_TICKS)
        substeps = torch_calibrate.mode_config(mode).sim.nav_decimation
        row = dict(
            routes=n_routes, repeat_ticks=ex, wall_s=wall,
            ms_per_tick=wall / ex * 1e3,
            env_steps_per_s=ex * substeps * n_routes / wall,
            launches=counts, repeat_path_m_mean=float(rep_path.mean()),
            wp_idx=rep.final.dispatch.idx.cpu().tolist(),
            stalled_routes=int(r.done[:, -1].sum()),
            anchor_attempts=sum(a["attempts"] for a in anchor.values()))
        if mode == "stock":
            committed = rep.final.fusion.committed.cpu().numpy()
            check(committed.all(), f"stock relays not committed: "
                  f"{committed.tolist()}")
            rp = r.recovery_phase
            entries = int(((rp[:, 1:] > 0) & (rp[:, :-1] == 0)).sum()
                          + (rp[:, 0] > 0).sum())
            check(entries == int(rep.final.ctrl.recovery_count.sum()),
                  "RPP recovery entries in the trace disagree with the "
                  "controller's count")
            row.update(rpp_recovery_entries=entries,
                       goal_blocked_ticks=int(r.goal_blocked.sum()),
                       goal_blocked_routes=int(r.goal_blocked.any(1).sum()),
                       k1_launches_per_tick=sites.get("vio", 0) / ex)
        else:
            check(bool((r.regime == REGIME_ENCODER).all())
                  and not r.vio_xy.any(),
                  "the encoder repeat is not pure dead reckoning")
        drift = np.hypot(*(r.nav_xy - r.gt_xy).transpose(2, 0, 1))
        row.update(nav_err_m_mean=float(drift.mean()),
                   nav_err_m_max=float(drift.max()))
        print(f"{mode}_campaign_metrics " + json.dumps(agg), flush=True)
        print(f"{mode}_main_path " + json.dumps(row), flush=True)
        stats[mode] = row
    return stats


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
    return stats, (data, teach, wps, n_wps, cfg)


@contextlib.contextmanager
def record_potentials(planner):
    """While the block runs, every ``planner.plan_window`` call appends a
    copy of its potential to the yielded list (``plan_world`` looks the
    name up at each call)."""
    seen = []
    inner = planner.plan_window

    def wrapped(*a, **kw):
        res = inner(*a, **kw)
        seen.append(res.potential.clone())
        return res

    planner.plan_window = wrapped
    try:
        yield seen
    finally:
        planner.plan_window = inner


def same_bits(a, b) -> bool:
    import numpy as np
    import torch
    a, b = (x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in (a, b))
    return a.shape == b.shape and a.dtype == b.dtype and \
        a.tobytes() == b.tobytes()


def determinism_phase(data, teach, wps, n_wps, cfg):
    """The GT repeat twice from one teach and one config: every trace, every
    tensor of the final state (the costmaps among them) and every
    ``plan_window`` potential bit-equal."""
    import numpy as np
    import torch
    from nclt_slam_tpu_torch.planning import wavefront as planner
    from nclt_slam_tpu_torch.rollout import campaign

    runs = []
    for _ in range(2):
        with record_potentials(planner) as pots:
            rep = campaign.run_campaign_repeat(
                data, teach.teach_grid, wps, n_wps, cfg, DETERMINISM_TICKS,
                stop_when_done=False)
        torch.cuda.synchronize()
        runs.append((rep, pots))
    (a, pa), (b, pb) = runs
    check(len(pa) > 0 and len(pa) == len(pb),
          f"determinism: plan_window ran {len(pa)} and {len(pb)} times")
    def leaves(tree, name):
        if not isinstance(tree, tuple):
            return [(name, tree)]
        return [x for f, sub in zip(tree._fields, tree)
                for x in leaves(sub, f"{name}.{f}")]

    diffs = []
    for name in a.trace._fields:
        x, y = getattr(a.trace, name), getattr(b.trace, name)
        if not same_bits(x, y):
            bad = np.flatnonzero((np.asarray(x) != np.asarray(y)).reshape(
                x.shape[0], x.shape[1], -1).any(-1).any(0))
            diffs.append(f"trace {name} from tick "
                         f"{int(bad[0]) if len(bad) else 'nan-only'}")
    final = list(zip(leaves(a.final, "final"), leaves(b.final, "final")))
    diffs += [name for (name, x), (_, y) in final if not same_bits(x, y)]
    diffs += [f"plan_window call {i}" for i, (x, y) in enumerate(zip(pa, pb))
              if not same_bits(x, y)]
    check(not diffs, "the GT repeat differs between two runs: "
          + "; ".join(diffs[:10]))
    stats = dict(ticks=executed(DETERMINISM_TICKS), plan_window_calls=len(pa),
                 final_leaves=len(final))
    print("gt_determinism: two runs bit-equal (traces, every final state "
          "tensor, plan_window potentials) " + json.dumps(stats), flush=True)
    return stats


def profile_window(fn, kernels=()):
    """Run ``fn`` under torch.profiler: (kernel launches, device busy
    seconds, wall seconds), and with ``kernels`` (parts of kernels' names)
    a fourth item, each name's (launches, device seconds).  Launches count
    ``cudaLaunchKernel`` and ``cudaLaunchKernelExC`` (a cluster launch)."""
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
    launches = sum(e.count for e in ka
                   if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"))
    on_card = [e for e in ka
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in on_card)
    if not kernels:
        return launches, busy_us * 1e-6, wall
    mine = {}
    for name in kernels:
        hits = [e for e in on_card if name in e.key]
        mine[name] = (sum(e.count for e in hits),
                      sum(e.self_device_time_total for e in hits) * 1e-6)
    return launches, busy_us * 1e-6, wall, mine


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
    tick, the device's busy share and K2's and K1's device time in it.  It
    runs after every timed phase: once the profiler has attached to the
    CUDA driver, launches stay slower for the rest of the process."""
    from nclt_slam_tpu_torch import config
    from nclt_slam_tpu_torch.rollout.repeat import run_repeat

    data, teach, wps, n_wps = shared
    launches, busy_s, wall, mine = profile_window(
        lambda: run_repeat(
            data.scenes_repeat, data.routes, teach.teach_grid, wps, n_wps,
            config.ours(), PROFILE_TICKS, store=teach.store, carry=carry,
            tick0=executed(OURS_REPEAT_TICKS)),
        kernels=("relax_kernel", "cross_check_kernel"))
    (k2_n, k2_s), (k1_n, k1_s) = mine["relax_kernel"], \
        mine["cross_check_kernel"]
    check(k1_n > 0, "the ours profile window shows no K1 launch")
    stats = dict(profiled_ticks=PROFILE_TICKS,
                 profiled_ms_per_tick=wall / PROFILE_TICKS * 1e3,
                 launches_per_tick=launches / PROFILE_TICKS,
                 device_busy_share=busy_s / wall,
                 device_ms=busy_s * 1e3, k2_launches=k2_n,
                 k2_device_ms=k2_s * 1e3, k1_launches=k1_n,
                 k1_device_ms=k1_s * 1e3)
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
               ("wavefront.cu", "hamming.cu", "ba.cu", "pgo.cu")):
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
    k4 = pgo_phase(dev)
    pgo_determinism = pgo_determinism_phase(dev)
    fixture_phase(dev)
    ours_fx = ours_fixture_phase(dev)
    rgbd_ba_fixture_phase(ours_fx, dev)
    baseline_fixture_phase(ours_fx, dev)
    stock_stall_phase(ours_fx, dev)
    del ours_fx
    slam_fixture_phase(dev)
    rgbd_slam = rgbd_slam_phase(dev)
    gt, gt_ctx = main_path_phase(dev)
    determinism = determinism_phase(*gt_ctx)
    del gt_ctx
    ours, shared, ours_carry = ours_main_path_phase(dev)
    rgbd_ba = rgbd_ba_main_path_phase(shared, dev)
    base = baseline_main_path_phase(shared, dev)
    terrain_tex_phase(shared, ours_carry)
    slam = slam_main_path_phase(dev, card)
    ours_profile = ours_profile_phase(shared, ours_carry)
    slam_profile_phase(dev)

    window, coarse = k2_rows
    vio_row, _, matcher_row, odo_row, loop_row = k1_rows
    k1_launches = ours["launches"]["k1"] + rgbd_ba["launches"]["k1"] + \
        base["stock"]["launches"]["k1"] + base["encoder"]["launches"]["k1"] \
        + rgbd_slam["k1_launches_rgbd_slam"]
    k2_launches = gt["launches"]["k2"] + ours["launches"]["k2"] + \
        rgbd_ba["launches"]["k2"] + base["stock"]["launches"]["k2"] + \
        base["encoder"]["launches"]["k2"]
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
            "launches_by_path": {
                "ours": ours["launches"]["k1_sites"],
                "rgbd_ba": rgbd_ba["launches"]["k1_sites"],
                "stock": base["stock"]["launches"]["k1_sites"],
                "encoder": base["encoder"]["launches"]["k1_sites"],
                "rgbd_slam": {"rgbd_slam":
                              rgbd_slam["k1_launches_rgbd_slam"]}},
            "plan": vio_row["plan"],
            "launch_floor_ms": vio_row["launch_floor_ms"],
            "eager_ms": vio_row["eager_ms"],
            "matcher_shape": matcher_row["shape"],
            "matcher_ms": matcher_row["ms"],
            "matcher_plain_ms": matcher_row["plain_ms"],
            "matcher_bound_ms": matcher_row["bound_ms"],
            "matcher_plan": matcher_row["plan"],
            "matcher_launch_floor_ms": matcher_row["launch_floor_ms"],
            "matcher_eager_ms": matcher_row["eager_ms"],
            "rgbd_slam_rows": [
                {k: row[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                     "bound_by", "eager_ms",
                                     "launch_floor_ms", "plan")}
                for row in (odo_row, loop_row)],
            "ours_profile_window": {
                "ticks": PROFILE_TICKS,
                "launches": ours_profile["k1_launches"],
                "device_ms": ours_profile["k1_device_ms"]},
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
                                 "rgbd_ba": rgbd_ba["launches"]["k2"],
                                 "stock": base["stock"]["launches"]["k2"],
                                 "encoder":
                                     base["encoder"]["launches"]["k2"]},
            "coarse_shape": coarse["shape"],
            "coarse_ms": coarse["ms"],
            "coarse_plain_ms": coarse["plain_ms"],
            "coarse_bound_ms": coarse["bound_ms"],
            "plan": window["plan"],
            "coarse_plan": coarse["plan"],
            "gt_determinism": determinism,
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
            "plan": k3["rollout"]["plan"],
            "launch_floor_ms": k3["rollout"]["launch_floor_ms"],
            "eager_ms": k3["rollout"]["eager_ms"],
            "host_us_per_call": k3["rollout"]["host_us_per_call"],
            "library_cholesky_solve_ms": k3["rollout"]["library_cholesky_ms"],
            "bench_plan": k3["bench"]["plan"],
            "bench_launch_floor_ms": k3["bench"]["launch_floor_ms"],
            "bench_eager_ms": k3["bench"]["eager_ms"],
            "sweep": k3["sweep"],
        },
        {
            "name": "optimize_pgo",
            "route": "cuda",
            "source": "nclt_slam_tpu_torch/csrc/pgo.cu",
            "replaces": "nclt_slam_tpu/ops/pgo_pallas.py:45",
            "launches": slam["launches"]["k4"],
            "max_abs_err": max(row["max_abs_err"]
                               for row in k4["checks"].values()),
            "ms": k4["timed"]["ms"],
            "plain_ms": k4["timed"]["plain_ms"],
            "bound_ms": k4["timed"]["bound_ms"],
            "bound_by": k4["timed"]["bound_by"],
            "library_ms": None,
            "shape": k4["timed"]["shape"],
            "launches_by_site": slam["launches"]["k4_sites"],
            "linalg_solve_x15_ms": k4["timed"]["linalg_solve_x15_ms"],
            "ms_per_iter": k4["timed"]["ms_per_iter"],
            "linalg_solve_ms": k4["timed"]["linalg_solve_ms"],
            "kernel_over_linalg_solve":
                k4["timed"]["kernel_over_linalg_solve"],
            "checks": k4["checks"],
            "dense_pgo_determinism": pgo_determinism,
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
