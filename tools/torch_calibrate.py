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
``teach_drift``, ``anchor``).  On the card (the default):

    python3 tools/torch_calibrate.py --routes all --mode all \\
        --ticks 600 --teach-ticks 600 --json runs/calib_MODE.json

``--mode all`` asks for a ``--json`` path holding ``MODE`` (each mode gets
its own file; a path without it is refused rather than overwritten mode
after mode).  ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

MODES = ("ours", "stock", "rgbd", "rgbd_ba", "encoder")

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


def run(route_names, mode: str, teach_ticks: int, repeat_ticks: int,
        device="cuda", shared=None):
    """One mode's campaign.  ``shared``: optional (data, teach, wps, n_wps)
    of a previous mode — the baselines consume the ours-stack teach
    artefacts.  Returns ((names, per_route, agg, teach_drift, anchor),
    shared, the repeat result)."""
    from nclt_slam_tpu_torch import config
    from nclt_slam_tpu_torch.rollout.campaign import (
        build_campaign,
        campaign_metrics,
        run_campaign_repeat,
        run_campaign_teach,
        teach_waypoints,
    )

    cfg = mode_config(mode)

    def prog(tag):
        def f(done_ticks, total, n_done):
            print(f"[calibrate] {tag} {done_ticks}/{total} ticks, "
                  f"{n_done} routes done", flush=True)
        return f

    if shared is None:
        teach_cfg = config.ours()   # teach always runs the full VI stack
        data = build_campaign(route_names, cfg=teach_cfg, device=device)
        print("[calibrate] campaign built", flush=True)
        teach = run_campaign_teach(data, teach_cfg, n_ticks=teach_ticks,
                                   progress=prog("teach"))
        wps, n_wps = teach_waypoints(data, teach, teach_cfg)
        shared = (data, teach, wps, n_wps)
    data, teach, wps, n_wps = shared
    rep = run_campaign_repeat(data, teach.teach_grid, wps, n_wps, cfg,
                              n_ticks=repeat_ticks, stores=teach.store,
                              progress=prog(f"repeat[{mode}]"))
    per_route, agg = campaign_metrics(data, rep, wps, n_wps, cfg)
    return ((data.names, per_route, agg, teach_drift(data.names, teach.trace),
             anchor_outcomes(data.names, rep.trace)), shared, rep)


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


def json_path(template: str | None, mode: str, modes) -> Path | None:
    """The JSON file of ``mode``: ``MODE`` in the template is replaced by
    the mode's name.  With more than one mode the template must hold
    ``MODE``, or each mode would overwrite the last one's file."""
    if template is None:
        return None
    if len(modes) > 1 and "MODE" not in template:
        raise SystemExit(f"--json {template!r} has no MODE for --mode all: "
                         f"every mode would overwrite one file")
    return Path(template.replace("MODE", mode))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--routes", default="08_nw_sw,01_road,02_north_forest",
                    help="comma-separated route names, or 'all'")
    ap.add_argument("--mode", default="ours", choices=MODES + ("all",))
    ap.add_argument("--ticks", type=int, default=12000)
    ap.add_argument("--teach-ticks", type=int, default=12000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None,
                    help="output path; MODE is replaced by the mode")
    args = ap.parse_args(argv)

    from nclt_slam_tpu_torch.scene.routes import ALL_ROUTES

    routes = (list(ALL_ROUTES) if args.routes == "all"
              else args.routes.split(","))
    modes = list(MODES) if args.mode == "all" else [args.mode]
    paths = {m: json_path(args.json, m, modes) for m in modes}
    shared = None
    for mode in modes:
        (names, per_route, agg, drift, anchor), shared, _ = run(
            routes, mode, args.teach_ticks, args.ticks, args.device,
            shared=shared)
        report(names, per_route, agg, drift, anchor, mode)
        if paths[mode] is not None:
            out = {"mode": mode, "per_route": per_route, "agg": agg,
                   "teach_drift": drift, "anchor": anchor}
            paths[mode].parent.mkdir(parents=True, exist_ok=True)
            paths[mode].write_text(json.dumps(out, indent=1, default=float))
            print(f"wrote {paths[mode]}")


if __name__ == "__main__":
    main()
