#!/usr/bin/env python3
"""Campaign calibration front end of the PyTorch port: every mode's 15-route
(or fewer) repeat off one shared teach, and its statistics beside the
reference's — the port's counterpart of ``tools/calibrate.py``.

One ``config.ours()`` campaign build and one teach (the full VI stack, as
the reference's baselines consume the ours-stack teach artefacts) serve
every mode; each mode then repeats off its map, waypoints and landmark
stores:

- ``ours``: ``config.ours()``;
- ``rgbd``: ``baselines.configs.rgbd_no_imu()`` (no inertial term, the
  GT-stall watchdog);
- ``stock``: ``baselines.configs.stock_nav2()`` (RPP, stock waypoint
  following, no anchors);
- ``encoder``: ``config.encoder_only()`` (encoder + compass dead
  reckoning);
- ``rgbd_ba``: ``baselines.configs.rgbd_ba()`` (``rgbd`` plus the local
  BA every tenth tick).

It reports per route the teach drift (Procrustes-aligned VIO against GT
over ``[200, n)``, the drift monitor's settling window skipped), the repeat
metrics, and the anchor outcomes counted over live attempts only (a route
that is done parks at spawn while the batch keeps ticking), and writes the
JSON keys of the JAX tool (``mode``, ``per_route``, ``agg``,
``teach_drift``, ``anchor``) and, beside them, the executed teach and
repeat ticks, the wall seconds of each phase and the card's ``nvidia-smi
--query-gpu=name,power.limit`` line.  On the card (the default):

    python3 tools/torch_calibrate.py --routes all --mode all \\
        --ticks 600 --teach-ticks 600 --json runs/calib_MODE.json

``--mode all`` asks for a ``--json`` path holding ``MODE`` (each mode gets
its own file; a path without it is refused rather than overwritten mode
after mode).  ``--device cpu`` runs on the CPU.

A full-length campaign (12,000 + 12,000 ticks) outlasts one bounded run,
so it runs in pieces:

- ``--teach-ckpt PATH``: a missing file is written after the teach (its
  map, landmark stores, trace, waypoints and timings); a present one is
  loaded and no teach runs (a teach of more routes gives the rows of the
  routes asked for).  ``--mode teach`` stops there, and writes the
  teach's drift and meta to ``--json``.  The campaign data is rebuilt
  from the seed either way.
- ``--repeat-ckpt PATH`` (``MODE`` replaced) with ``--budget-s S``: at a
  chunk boundary past which the next chunk would not fit in ``S`` seconds
  of the process, the repeat's carry and its trace so far are written
  there and the tool exits with code 75; the next run with the same flags
  continues it at that tick, and the file is removed once the mode's
  table is written.  Every run advances at least one chunk.

    python3 tools/torch_calibrate.py --routes all --mode teach \\
        --teach-ckpt runs/teach.ckpt
    python3 tools/torch_calibrate.py --routes all --mode ours \\
        --teach-ckpt runs/teach.ckpt --repeat-ckpt runs/MODE.ckpt \\
        --budget-s 3300 --json artifacts/calibration_torch/MODE.json

The pieces give the one-call run's table bit for bit: the repeat is the
same chain of ``run_campaign_repeat`` chunks, continued through its
``carry`` / ``tick0``.

``--seeds 1-8`` (or ``1,3,5``; default ``1``) runs the repeat's seed axis
as more batch rows off the one shared teach: row ``s * R + r`` is route
``r`` at ``seeds[s]``, its block started from ``init_repeat_carry(...,
seed=seeds[s])``, what ``run_repeat(seed=...)`` starts from.  The batch
stops once every row of every seed is done; each seed's table is taken
over the ticks its own untiled run would have executed (up to the first
chunk boundary at which all of its routes are done), so it does not
depend on the other seeds.  With any seeds but ``1`` alone, ``--json``
gets one file holding a table per seed (``seeds``, ``tables``) beside the
executed ticks, timings, peak device memory and card line; each table
also counts the localization events per route (``route_events``):

    python3 tools/torch_calibrate.py --routes all --mode stock \
        --seeds 1-8 --teach-ckpt runs/teach.ckpt \
        --repeat-ckpt runs/MODE_seeds.ckpt --budget-s 3300 \
        --json artifacts/calibration_torch/seeds/MODE.json
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

MODES = ("ours", "stock", "rgbd", "rgbd_ba", "encoder")

# exit code of a run that paused its repeat (checkpointed, to be continued)
PAUSED = 75

# Reference teach drift mean/max [m] (routes/README.md:24-40; 03 unrecorded)
REF_TEACH_DRIFT = {
    "01_road": (0.45, 0.69), "02_north_forest": (0.38, 0.91),
    "04_nw_se": (0.64, 1.10), "05_ne_sw": (0.48, 0.99),
    "06_nw_ne": (0.65, 1.18), "07_se_sw": (0.42, 1.00),
    "08_nw_sw": (0.34, 0.72), "09_se_ne": (0.40, 0.64),
    "10_nmid_smid": (0.52, 0.78), "11_nw_mid": (0.48, 0.82),
    "12_ne_mid": (0.52, 0.86), "13_cross_nws": (0.55, 0.94),
    "14_se_mid": (0.43, 0.71), "15_wmid_smid": (0.58, 0.96),
}

# Reference ours-stack repeat results (routes/README.md:132-151):
# (reach_m, return_m, cov_pct, drift_mean, drift_p95, drift_max)
REF_REPEAT_OURS = {
    "01_road": (0.6, 12.3, 96, 1.4, 2.2, 2.3),
    "02_north_forest": (1.0, 24.2, 52, 4.4, 10.1, 12.1),
    "03_south": (5.7, 5.9, 89, 2.0, 3.4, 3.6),
    "04_nw_se": (7.8, 5.0, 58, 5.3, 9.4, 10.0),
    "05_ne_sw": (2.5, 31.4, 81, 9.9, 37.7, 38.0),
    "06_nw_ne": (5.3, 10.2, 60, 5.7, 9.1, 9.2),
    "07_se_sw": (0.6, 14.7, 74, 3.8, 5.8, 5.9),
    "08_nw_sw": (3.1, 3.0, 86, 0.9, 1.9, 2.0),
    "09_se_ne": (3.7, 4.0, 81, 5.2, 5.7, 5.7),
    "10_nmid_smid": (4.2, 4.8, 82, 3.0, 3.8, 3.9),
    "11_nw_mid": (3.1, 5.2, 80, 2.0, 2.8, 2.8),
    "12_ne_mid": (1.1, 11.8, 83, 5.2, 7.3, 7.7),
    "13_cross_nws": (2.6, 28.7, 61, 18.8, 24.1, 25.3),
    "14_se_mid": (3.7, 2.7, 28, 2.6, 5.1, 5.1),
    "15_wmid_smid": (4.8, 6.5, 50, 7.2, 11.5, 11.8),
}

# Reference stock-Nav2 repeat results (exp 74, routes/README.md:160-178)
REF_REPEAT_STOCK = {
    "01_road": (56.1, 85.0, 36, 1.2, 2.8, 3.4),
    "02_north_forest": (155.0, 16.7, 3, 2.2, 3.9, 3.9),
    "03_south": (149.9, 21.3, 8, 1.7, 2.5, 4.2),
    "04_nw_se": (144.8, 21.1, 8, 1.6, 2.9, 3.0),
    "05_ne_sw": (132.7, 38.1, 10, 1.3, 2.0, 2.0),
    "06_nw_ne": (110.5, 62.0, 19, 2.3, 3.8, 3.9),
    "07_se_sw": (116.4, 29.9, 8, 1.0, 2.0, 2.6),
    "08_nw_sw": (0.7, 81.2, 42, 0.5, 0.9, 1.0),
    "09_se_ne": (8.7, 12.6, 61, 0.6, 1.0, 1.8),
    "10_nmid_smid": (71.0, 12.8, 5, 0.0, 0.0, 0.0),
    "11_nw_mid": (70.1, 17.1, 5, 1.1, 2.0, 2.4),
    "12_ne_mid": (39.0, 53.7, 20, 3.8, 7.4, 7.9),
    "13_cross_nws": (39.9, 22.9, 24, 2.6, 5.2, 5.5),
    "14_se_mid": (32.9, 143.9, 0, 1.2, 1.5, 13.9),
    "15_wmid_smid": (62.5, 32.9, 7, 1.4, 2.6, 3.4),
}

# Anchor outcome distribution oracle (exp 76 run_09 anchor_matches.csv,
# 680 attempts) + publish-shift stats [m]
REF_ANCHOR = {
    "published": 0.381, "no_pnp_accept": 0.450, "no_candidates": 0.128,
    "consistency_fail": 0.041,
    "shift_median": 1.2, "shift_p90": 3.3, "inliers_mean": 31.8,
}

REASON_NAMES = {0: "published", 1: "no_candidates", 2: "no_features",
                3: "no_pnp_accept", 4: "consistency_fail"}


def mode_config(mode: str):
    from nclt_slam_tpu_torch import config
    from nclt_slam_tpu_torch.baselines import configs as baselines

    return {"ours": config.ours, "rgbd": baselines.rgbd_no_imu,
            "stock": baselines.stock_nav2, "encoder": config.encoder_only,
            "rgbd_ba": baselines.rgbd_ba}[mode]()


def teach_drift(names, trace) -> dict:
    """Per route (mean, max) drift of the Procrustes-aligned teach VIO track
    against GT over the live ticks [200, n), like the drift monitor after
    its settling window."""
    from nclt_slam_tpu_torch.eval.metrics import procrustes_drift_2d

    tvio = np.asarray(trace.vio_xy)
    tgt = np.asarray(trace.gt_xy)
    tdone = np.asarray(trace.done)
    out = {}
    for i, name in enumerate(names):
        n = int((~tdone[i]).sum())
        sl = slice(200, max(n, 201))
        vio = tvio[i][sl]
        vio3 = np.concatenate([vio, np.zeros((vio.shape[0], 1))], 1)
        mx, mean = procrustes_drift_2d(vio3, tgt[i][sl])
        out[name] = (mean, mx)
    return out


def anchor_outcomes(names, trace) -> dict:
    """Per route anchor-attempt outcome fractions and publish-shift /
    inlier statistics over LIVE attempts (route not done): a done route
    parks at spawn while the batch keeps ticking, and its parked attempts
    would swamp the route's outcome mix."""
    reasons = np.asarray(trace.anchor_reason)
    shifts = np.asarray(trace.anchor_shift)
    inliers = np.asarray(trace.anchor_inliers)
    done = np.asarray(trace.done)
    ok = np.asarray(trace.anchor_ok) & ~done
    out = {}
    for i, name in enumerate(names):
        att = (reasons[i] >= 0) & ~done[i]
        n_att = int(att.sum())
        hist = collections.Counter(reasons[i][att].tolist())
        frac = {REASON_NAMES[k]: v / max(n_att, 1) for k, v in hist.items()}
        sh = shifts[i][ok[i]]
        inl = inliers[i][ok[i]]
        out[name] = {
            "attempts": n_att, "frac": frac,
            "shift_median": float(np.median(sh)) if len(sh) else 0.0,
            "shift_p90": float(np.percentile(sh, 90)) if len(sh) else 0.0,
            "inliers_mean": float(inl.mean()) if len(inl) else 0.0,
        }
    return out


# VioAux.flags bits (vio/tracker.py): lost, relocalized, snap event fired
FLAG_LOST, FLAG_RELOC, FLAG_SNAP = 3, 4, 5
# a tick whose (nav - gt) offset moves by more than this is a jump [m]
JUMP_M = 0.5
# seconds between VIO frames: one frame a navigation tick (0.1 s)
FRAME_DT = 0.1


def route_events(names, trace, vio_cfg) -> dict:
    """Per route counts of the localization events over LIVE ticks (route
    not done), from the repeat trace both packages keep:

    - ``stressed``: frames the snap model calls stressed, by
      ``snap_stress_match_n`` on ``vio_tracked`` or ``snap_stress_rot`` on
      the GT yaw rate (the model reads the VIO's own rotation, which the
      trace does not keep); ``stress_armed``: such frames at least
      ``snap_stress_min`` in a row;
    - ``starved``: frames under ``snap_starve_match_n`` matches;
      ``starve_armed``: at least ``snap_starve_min`` in a row;
    - ``lost``, ``reloc``, ``snaps``: the VIO flags' bits;
    - ``jumps``: ticks where ``|d(nav_xy - gt_xy)|`` exceeds ``JUMP_M``;
    - ``published``: anchors published."""
    done = np.asarray(trace.done)
    tracked = np.asarray(trace.vio_tracked)
    flags = np.asarray(trace.vio_flags)
    yaw = np.asarray(trace.gt_yaw, np.float64)
    off = np.asarray(trace.nav_xy, np.float64) - np.asarray(trace.gt_xy,
                                                            np.float64)
    ok = np.asarray(trace.anchor_ok)

    def armed(x, n):
        run, out = 0, np.zeros(len(x), bool)
        for t, v in enumerate(x):
            run = run + 1 if v else 0
            out[t] = run >= n
        return out

    out = {}
    for i, name in enumerate(names):
        live = ~done[i]
        dyaw = np.diff(yaw[i], prepend=yaw[i][:1])
        rate = np.abs(np.arctan2(np.sin(dyaw), np.cos(dyaw))) / FRAME_DT
        stressed = (tracked[i] < vio_cfg.snap_stress_match_n) | \
            (rate > vio_cfg.snap_stress_rot)
        starved = tracked[i] < vio_cfg.snap_starve_match_n
        jump = np.linalg.norm(np.diff(off[i], axis=0, prepend=off[i][:1]),
                              axis=-1) > JUMP_M
        out[name] = {
            "live_ticks": int(live.sum()),
            "stressed": int((stressed & live).sum()),
            "stress_armed": int((armed(stressed, vio_cfg.snap_stress_min)
                                 & live).sum()),
            "starved": int((starved & live).sum()),
            "starve_armed": int((armed(starved, vio_cfg.snap_starve_min)
                                 & live).sum()),
            "lost": int((((flags[i] >> FLAG_LOST) & 1).astype(bool)
                         & live).sum()),
            "reloc": int((((flags[i] >> FLAG_RELOC) & 1).astype(bool)
                          & live).sum()),
            "snaps": int((((flags[i] >> FLAG_SNAP) & 1).astype(bool)
                          & live).sum()),
            "jumps": int((jump & live).sum()),
            "published": int((ok[i] & live).sum()),
        }
    return out


def run(route_names, mode: str, teach_ticks: int, repeat_ticks: int,
        device="cuda", shared=None, chunk: int = 250):
    """One mode's campaign in one call: the teach (unless ``shared``, the
    (data, teach, wps, n_wps) of a previous mode — the baselines consume
    the ours-stack teach artefacts) and ``repeat_phase`` without a
    checkpoint.  Returns ((names, per_route, agg, teach_drift, anchor),
    shared, the repeat result)."""
    from nclt_slam_tpu_torch.rollout.campaign import campaign_metrics

    if shared is None:
        shared = run_teach(route_names, teach_ticks, device, chunk)
    data, teach, wps, n_wps = shared
    rep, _ = repeat_phase(shared, mode, repeat_ticks, chunk, None, None,
                          0.0, None)
    per_route, agg = campaign_metrics(data, rep, wps, n_wps,
                                      mode_config(mode))
    return ((data.names, per_route, agg, teach_drift(data.names, teach.trace),
             anchor_outcomes(data.names, rep.trace)), shared, rep)


def progress(tag):
    def f(done_ticks, total, n_done):
        print(f"[calibrate] {tag} {done_ticks}/{total} ticks, "
              f"{n_done} routes done", flush=True)
    return f


def build(route_names, device):
    """The campaign data, rebuilt from the seed (``config.ours()``: the teach
    always runs the full VI stack)."""
    from nclt_slam_tpu_torch import config
    from nclt_slam_tpu_torch.rollout.campaign import build_campaign

    data = build_campaign(route_names, cfg=config.ours(), device=device)
    print("[calibrate] campaign built", flush=True)
    return data


def run_teach(route_names, teach_ticks: int, device, chunk: int = 250,
              data=None):
    """The shared teach: (data, teach, wps, n_wps)."""
    from nclt_slam_tpu_torch import config
    from nclt_slam_tpu_torch.rollout.campaign import (
        run_campaign_teach,
        teach_waypoints,
    )

    teach_cfg = config.ours()
    if data is None:
        data = build(route_names, device)
    teach = run_campaign_teach(data, teach_cfg, n_ticks=teach_ticks,
                               chunk=chunk, progress=progress("teach"))
    wps, n_wps = teach_waypoints(data, teach, teach_cfg)
    return data, teach, wps, n_wps


def card_line(device) -> str | None:
    """``nvidia-smi --query-gpu=name,power.limit`` of the card a CUDA run
    uses (None on the CPU or where nvidia-smi does not answer)."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        return None
    return lines[min(dev.index or 0, len(lines) - 1)].strip()


def save_teach(path, shared, meta: dict):
    """The teach checkpoint: map, landmark stores, teach trace, waypoints
    and ``meta`` (routes, ticks, timings, card)."""
    import torch

    from nclt_slam_tpu_torch.io.artifacts import save_checkpoint
    from nclt_slam_tpu_torch.rollout.teach import TeachTrace

    _, teach, wps, n_wps = shared
    trace = TeachTrace(*(torch.from_numpy(np.asarray(x))
                         for x in teach.trace))
    save_checkpoint({"grid": teach.teach_grid, "store": teach.store,
                     "trace": trace, "n_ticks": teach.n_ticks, "wps": wps,
                     "n_wps": n_wps, "meta": meta}, path)


def load_teach(path, data, device):
    """A teach checkpoint -> ((data, teach, wps, n_wps), meta); the teach
    has no final carry (a repeat starts from the waypoints).  A checkpoint
    of more routes than ``data`` gives their rows (``teach_rows``)."""
    from nclt_slam_tpu_torch.io.artifacts import load_checkpoint
    from nclt_slam_tpu_torch.rollout.teach import TeachResult, TeachTrace

    blob = load_checkpoint(path, device)
    names = list(data.names)
    if blob["meta"]["routes"] != names and set(names) <= set(
            blob["meta"]["routes"]):
        blob = teach_rows(blob, names)
    trace = TeachTrace(*(x.cpu().numpy() for x in blob["trace"]))
    teach = TeachResult(trace=trace, teach_grid=blob["grid"],
                        store=blob["store"],
                        n_ticks=blob["n_ticks"].cpu(), final=None)
    return (data, teach, blob["wps"], blob["n_wps"]), blob["meta"]


def teach_rows(blob: dict, names) -> dict:
    """The rows of routes ``names`` of a loaded teach checkpoint: every
    tensor of it leads with the route axis, and the campaign is rebuilt
    per route, so the subset is those routes' teach to the bit (a repeat
    of a few routes off a 15-route teach)."""
    import torch

    meta = blob["meta"]
    rows = torch.tensor([meta["routes"].index(n) for n in names])

    def pick(tree):
        if isinstance(tree, torch.Tensor):
            return tree[rows.to(tree.device)]
        if isinstance(tree, dict):
            return {k: pick(v) for k, v in tree.items()}
        return type(tree)(*(pick(x) for x in tree))

    out = pick({k: v for k, v in blob.items() if k != "meta"})
    out["meta"] = dict(meta, routes=list(names),
                       subset_of=meta.get("subset_of", meta["routes"]))
    return out


def teach_phase(route_names, teach_ticks: int, device, ckpt, chunk: int,
                card):
    """Load the teach from ``ckpt`` or run it (and write ``ckpt`` when a
    path is given).  Returns (shared, meta)."""
    import torch

    t0 = time.perf_counter()
    data = build(route_names, device)
    build_s = time.perf_counter() - t0
    if ckpt is not None and Path(ckpt).is_file():
        t0 = time.perf_counter()
        shared, meta = load_teach(ckpt, data, device)
        want = {"routes": list(data.names), "teach_ticks": teach_ticks,
                "chunk": chunk}
        got = {k: meta[k] for k in want}
        if got != want:
            raise SystemExit(f"{ckpt} holds a teach of {got}, not {want}")
        print(f"[calibrate] teach loaded <- {ckpt} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        return shared, meta
    t0 = time.perf_counter()
    shared = run_teach(None, teach_ticks, device, chunk, data=data)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    teach_s = time.perf_counter() - t0
    meta = {"routes": list(data.names), "teach_ticks": teach_ticks,
            "chunk": chunk,
            "teach_ticks_executed": int(shared[1].trace.done.shape[1]),
            "build_s": build_s, "teach_s": teach_s, "card": card}
    if ckpt is not None:
        t0 = time.perf_counter()
        save_teach(ckpt, shared, meta)
        print(f"[calibrate] teach checkpoint -> {ckpt} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return shared, meta


def cat_rows(trees):
    """Concatenate states along their leading (route) dimension."""
    import torch

    if isinstance(trees[0], torch.Tensor):
        return torch.cat(trees, 0)
    return type(trees[0])(*(cat_rows(xs) for xs in zip(*trees)))


def seed_batch(shared, mode: str, seeds):
    """The repeat's seed axis as more batch rows, seed-major (row ``s * R +
    r`` is route ``r`` at ``seeds[s]``): the campaign data, teach map,
    waypoints and landmark stores tiled by ``expand_for_ablations``'s
    ``torch.cat`` (one "drops" block a seed), and the carry the blocks of
    ``init_repeat_carry(..., seed=s)`` on the mode's waypoints, what
    ``run_repeat(seed=s)`` starts from.  Returns (data, teach_grid, wps,
    n_wps, stores, carry)."""
    from nclt_slam_tpu_torch.rollout.campaign import (
        apply_stock_projection,
        expand_for_ablations,
    )
    from nclt_slam_tpu_torch.rollout.repeat import init_repeat_carry

    data, teach, wps, n_wps = shared
    cfg = mode_config(mode)
    big, grid, wps_k, n_k, stores, _ = expand_for_ablations(
        data, teach.teach_grid, wps, n_wps, teach.store,
        ablations=("drops",) * len(seeds))
    run_wps, run_n = apply_stock_projection(teach.teach_grid, wps, n_wps,
                                            cfg)
    carry = cat_rows([init_repeat_carry(data.routes, run_wps, run_n, cfg,
                                        seed=s) for s in seeds])
    return big, grid, wps_k, n_k, stores, carry


def repeat_phase(shared, mode: str, repeat_ticks: int, chunk: int, ckpt,
                 budget_s, t_process: float, card, seeds=(1,)):
    """The mode's repeat at ``seeds`` (``seed_batch``; one block at seed 1
    is the untiled run): one ``run_campaign_repeat`` call, continued from
    ``ckpt`` if it holds one, paused at the chunk boundary past which the
    next chunk would not fit in ``budget_s`` seconds of the process (None:
    never).  Returns (RepeatResult of every row, meta), or None when it
    paused (the carry and the trace so far are then in ``ckpt``)."""
    import torch

    from nclt_slam_tpu_torch.io.artifacts import (
        load_checkpoint,
        save_checkpoint,
    )
    from nclt_slam_tpu_torch.rollout.campaign import (
        planned_chunks,
        run_campaign_repeat,
    )
    from nclt_slam_tpu_torch.rollout.repeat import RepeatResult, RepeatTrace

    data = shared[0]
    big, grid, wps, n_wps, stores, carry = seed_batch(shared, mode, seeds)
    dev = wps.device
    n_chunks, chunk = planned_chunks(repeat_ticks, chunk)
    before, tick = [], 0
    meta = {"mode": mode, "routes": list(data.names),
            "repeat_ticks": repeat_ticks, "chunk": chunk,
            "seeds": list(seeds), "repeat_s": 0.0, "calls": 0, "cards": [],
            "peak_bytes": 0}
    if ckpt is not None and Path(ckpt).is_file():
        blob = load_checkpoint(ckpt, dev)
        old = blob["meta"]
        want = {k: meta[k] for k in ("mode", "routes", "repeat_ticks",
                                     "chunk", "seeds")}
        if {k: old.get(k) for k in want} != want:
            raise SystemExit(f"{ckpt} holds a repeat of "
                             f"{ {k: old.get(k) for k in want} }, not "
                             f"{want}")
        meta = old
        carry, tick = blob["carry"], old["tick"]
        before = [RepeatTrace(*(x.cpu().numpy() for x in blob["trace"]))]
        print(f"[calibrate] repeat[{mode}] continues at tick {tick} "
              f"<- {ckpt}", flush=True)
    meta["calls"] += 1
    if card not in meta["cards"]:
        meta["cards"].append(card)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t_call = time.perf_counter()
    last = [t_call]
    paused = []

    def pause(next_tick):
        now = time.perf_counter()
        piece_s, last[0] = now - last[0], now
        if budget_s is not None and now - t_process + 1.5 * piece_s > \
                budget_s and next_tick < repeat_ticks:
            paused.append(next_tick)
        return bool(paused)

    # a whole number of chunks from ``tick``: the one-call run's schedule
    res = run_campaign_repeat(big, grid, wps, n_wps, mode_config(mode),
                              n_ticks=n_chunks * chunk - tick,
                              stores=stores, chunk=chunk,
                              progress=progress(f"repeat[{mode}]"),
                              carry=carry, tick0=tick, pause=pause)
    sync()
    meta["repeat_s"] += time.perf_counter() - t_call
    if cuda:
        meta["peak_bytes"] = max(meta["peak_bytes"],
                                 torch.cuda.max_memory_allocated(dev))
    meta["tick"] = tick + res.trace.done.shape[1]
    parts = before + [res.trace]
    if paused:
        save_checkpoint({"carry": res.final, "meta": meta,
                         "trace": RepeatTrace(*(
                             torch.from_numpy(np.concatenate(xs, 1))
                             for xs in zip(*parts)))}, ckpt)
        print(f"[calibrate] repeat[{mode}] paused at tick {meta['tick']} "
              f"-> {ckpt}", flush=True)
        return None
    trace = RepeatTrace(*(np.concatenate(xs, 1)[:, :repeat_ticks]
                          for xs in zip(*parts)))
    return RepeatResult(trace=trace, final=res.final), meta


def seed_stop(done, repeat_ticks: int, chunk: int) -> int:
    """The repeat ticks an untiled run of these rows executes (``done``
    their (R, T) trace flags): ``run_campaign_repeat`` stops at the first
    chunk boundary at which every row is done, else runs ``repeat_ticks``
    (its trace trimmed to them)."""
    from nclt_slam_tpu_torch.rollout.campaign import planned_chunks

    n_chunks, chunk = planned_chunks(repeat_ticks, chunk)
    for end in range(chunk, n_chunks * chunk, chunk):
        if done[:, end - 1].all():
            return end
    return repeat_ticks


def seed_tables(shared, rep, mode: str, seeds, repeat_ticks: int,
                chunk: int, drift) -> dict:
    """Each seed's table from the seed batch's result: seed -> (table, the
    repeat ticks of its own untiled run, ``seed_stop``)."""
    from nclt_slam_tpu_torch.rollout.campaign import campaign_metrics
    from nclt_slam_tpu_torch.rollout.repeat import RepeatResult, RepeatTrace

    data, _, wps, n_wps = shared
    R = len(data.names)
    out = {}
    for i, s in enumerate(seeds):
        rows = slice(i * R, (i + 1) * R)
        n = seed_stop(rep.trace.done[rows], repeat_ticks, chunk)
        trace = RepeatTrace(*(np.asarray(x)[rows, :n] for x in rep.trace))
        per_route, agg = campaign_metrics(
            data, RepeatResult(trace=trace, final=None), wps, n_wps,
            mode_config(mode))
        out[s] = (dict(table(data.names, per_route, agg, drift,
                             anchor_outcomes(data.names, trace), mode),
                       events=route_events(data.names, trace,
                                           mode_config(mode).vio)), n)
    return out


def report(names, per_route, agg, teach_drift, anchor, mode):
    ref_repeat = REF_REPEAT_STOCK if mode == "stock" else REF_REPEAT_OURS
    print(f"\n=== calibration report (mode={mode}) ===")
    print(f"{'route':<16} {'teach m/mx':>12} {'ref':>10} | "
          f"{'drift m/p95':>12} {'ref':>10} | {'cov%':>5} {'ref':>4} | "
          f"{'reach':>6} {'ret':>6}")
    for name in names:
        m = per_route[name]
        td = teach_drift.get(name, (0, 0))
        rt = REF_TEACH_DRIFT.get(name)
        rr = ref_repeat.get(name)
        print(f"{name:<16} {td[0]:>5.2f}/{td[1]:>5.2f} "
              f"{(f'{rt[0]:>4.2f}/{rt[1]:>4.2f}' if rt else '   n/a'):>10} | "
              f"{m['drift_mean']:>5.1f}/{m['drift_p95']:>5.1f} "
              f"{(f'{rr[3]:>4.1f}/{rr[4]:>4.1f}' if rr else '   n/a'):>10} | "
              f"{m['cov_pct']:>5.0f} {(rr[2] if rr else 0):>4.0f} | "
              f"{m['final_d']:>6.1f} {m['return_d']:>6.1f}")

    tot = sum(a["attempts"] for a in anchor.values())
    frac = collections.Counter()
    for a in anchor.values():
        for k, v in a["frac"].items():
            frac[k] += v * a["attempts"] / max(tot, 1)
    print(f"\nanchor outcomes over {tot} attempts (ref in parens):")
    for k in ("published", "no_pnp_accept", "no_candidates",
              "consistency_fail", "no_features"):
        print(f"  {k:<18} {frac.get(k, 0) * 100:>5.1f} % "
              f"({REF_ANCHOR.get(k, 0) * 100:.1f} %)")
    med = [a["shift_median"] for a in anchor.values() if a["attempts"]]
    p90 = [a["shift_p90"] for a in anchor.values() if a["attempts"]]
    inl = [a["inliers_mean"] for a in anchor.values() if a["attempts"]]
    if med:
        print(f"  publish shift median {np.mean(med):.2f} m "
              f"(ref {REF_ANCHOR['shift_median']}) | p90 {np.mean(p90):.2f} "
              f"(ref {REF_ANCHOR['shift_p90']}) | inliers {np.mean(inl):.1f} "
              f"(ref {REF_ANCHOR['inliers_mean']})")
    print(f"\naggregate: reach {agg['reach']}/{agg['routes']} "
          f"return {agg['return']}/{agg['routes']} "
          f"cov {agg['avg_coverage_pct']:.0f}% "
          f"drift {agg['avg_drift_mean']:.2f} m "
          f"(ref ours: 15/15, 8/15, 70%, 5.2 m)")


def table(names, per_route, agg, drift, anchor, mode) -> dict:
    """The JAX tool's JSON keys."""
    return {"mode": mode, "per_route": per_route, "agg": agg,
            "teach_drift": drift, "anchor": anchor}


def json_path(template: str | None, mode: str, modes,
              flag: str = "--json") -> Path | None:
    """The file of ``mode``: ``MODE`` in the template is replaced by the
    mode's name.  With more than one mode the template must hold ``MODE``,
    or each mode would overwrite the last one's file."""
    if template is None:
        return None
    if len(modes) > 1 and "MODE" not in template:
        raise SystemExit(f"{flag} {template!r} has no MODE for --mode all: "
                         f"every mode would overwrite one file")
    return Path(template.replace("MODE", mode))


def parse_seeds(text: str) -> tuple[int, ...]:
    """``--seeds``: ranges and single seeds, comma-separated (``1-8``,
    ``1,3,5``), in the order given; no seed twice."""
    seeds = []
    try:
        for part in text.split(","):
            lo, _, hi = part.partition("-")
            seeds += range(int(lo), int(hi or lo) + 1)
    except ValueError:
        raise argparse.ArgumentTypeError(f"not a seed list: {text!r}")
    if not seeds or len(set(seeds)) != len(seeds):
        raise argparse.ArgumentTypeError(
            f"{text!r} gives no seed or a seed twice")
    return tuple(seeds)


def report_seeds(tables: dict, mode: str) -> None:
    """One line a seed: its executed ticks and the banded aggregates."""
    print(f"\n=== seed tables (mode={mode}) ===")
    for s, (t, n) in tables.items():
        a = t["agg"]
        tot = sum(x["attempts"] for x in t["anchor"].values())
        print(f"seed {s:>3}: {n:>6} ticks | reach {a['reach']}/{a['routes']} "
              f"return {a['return']}/{a['routes']} "
              f"cov {a['avg_coverage_pct']:.1f}% "
              f"drift {a['avg_drift_mean']:.2f} m | {tot} anchor attempts")


def main(argv=None):
    t_process = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--routes", default="08_nw_sw,01_road,02_north_forest",
                    help="comma-separated route names, or 'all'")
    ap.add_argument("--mode", default="ours",
                    choices=MODES + ("all", "teach"),
                    help="'teach' runs (or loads) the teach alone")
    ap.add_argument("--ticks", type=int, default=12000)
    ap.add_argument("--teach-ticks", type=int, default=12000)
    ap.add_argument("--chunk", type=int, default=250,
                    help="ticks between the runners' host waits")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None,
                    help="output path; MODE is replaced by the mode")
    ap.add_argument("--teach-ckpt", default=None,
                    help="teach checkpoint: loaded if present, else written")
    ap.add_argument("--repeat-ckpt", default=None,
                    help="repeat checkpoint (MODE is replaced by the mode)")
    ap.add_argument("--budget-s", type=float, default=None,
                    help="pause the repeat into --repeat-ckpt before the "
                         "process has run this long")
    ap.add_argument("--seeds", type=parse_seeds, default=(1,),
                    help="the repeat's seeds as batch rows, e.g. 1-8; any "
                         "but 1 alone writes a table a seed into --json")
    args = ap.parse_args(argv)

    from nclt_slam_tpu_torch.scene.routes import ALL_ROUTES

    routes = (list(ALL_ROUTES) if args.routes == "all"
              else args.routes.split(","))
    modes = ([] if args.mode == "teach" else
             list(MODES) if args.mode == "all" else [args.mode])
    paths = {m: json_path(args.json, m, modes) for m in modes}
    ckpts = {m: json_path(args.repeat_ckpt, m, modes, "--repeat-ckpt")
             for m in modes}
    if args.budget_s is not None and args.repeat_ckpt is None:
        ap.error("--budget-s needs --repeat-ckpt")
    card = card_line(args.device)
    shared, teach_meta = teach_phase(routes, args.teach_ticks, args.device,
                                     args.teach_ckpt, args.chunk, card)
    data, teach = shared[:2]
    drift = teach_drift(data.names, teach.trace)
    if args.mode == "teach":
        for name, (mean, mx) in drift.items():
            print(f"teach_drift {name:<16} {mean!r} {mx!r}")
        if args.json is not None:
            path = Path(args.json)
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps({"teach_drift": drift,
                                        "teach_meta": teach_meta},
                                       indent=1, default=float))
            print(f"wrote {path}")
    for mode in modes:
        out = repeat_phase(shared, mode, args.ticks, args.chunk, ckpts[mode],
                           args.budget_s, t_process, card, args.seeds)
        if out is None:
            return PAUSED
        rep, meta = out
        t0 = time.perf_counter()
        tables = seed_tables(shared, rep, mode, args.seeds, args.ticks,
                             meta["chunk"], drift)
        metrics_s = time.perf_counter() - t0
        one = args.seeds == (1,)
        if one:
            report(data.names, *(tables[1][0][k] for k in (
                "per_route", "agg", "teach_drift", "anchor")), mode)
        else:
            report_seeds(tables, mode)
        if paths[mode] is not None:
            executed = {"teach": teach_meta["teach_ticks_executed"],
                        "repeat": meta["tick"]}
            wall = {"build": teach_meta["build_s"],
                    "teach": teach_meta["teach_s"],
                    "repeat": meta["repeat_s"], "metrics": metrics_s}
            out = (dict(tables[1][0]) if one else
                   {"mode": mode, "seeds": list(args.seeds),
                    "rows": len(args.seeds) * len(data.names),
                    "tables": {str(s): dict(t, repeat_ticks=n)
                               for s, (t, n) in tables.items()},
                    "peak_memory_bytes": meta["peak_bytes"]})
            out.update(
                ticks_executed=executed, wall_s=wall,
                ms_per_tick={k: wall[k] / executed[k] * 1e3
                             for k in executed},
                repeat_calls=meta["calls"],
                card={"teach": teach_meta["card"],
                      "repeat": meta["cards"]})
            paths[mode].parent.mkdir(parents=True, exist_ok=True)
            paths[mode].write_text(json.dumps(out, indent=1, default=float))
            print(f"wrote {paths[mode]}")
        if ckpts[mode] is not None and ckpts[mode].is_file():
            ckpts[mode].unlink()
    return 0


if __name__ == "__main__":
    sys.exit(main())
