"""Repeat-pass CLI — the run_repeat_ours.sh equivalent
(``nclt_slam_tpu/cli/repeat.py``).

    python -m nclt_slam_tpu_torch.cli.repeat --route 03_south \\
        --teach-dir /tmp/tr/03_south/teach --out /tmp/tr/03_south/repeat

Loads the teach artefacts (map, landmarks, dense poses) written by either
package, runs the repeat rollout of one route with the chosen localization
stack and obstacle drops on the CUDA card (or ``--device cpu``), and
writes traj_gt.csv / nav_pose.csv / metrics.json.  Like the JAX CLI, this
single-route CLI feeds the waypoints as they are: the stock baseline's
one-time teach-map projection runs in the campaign runner only
(``rollout/campaign.py:run_campaign_repeat``).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from nclt_slam_tpu_torch.cli.common import (
    add_device_arg,
    batch1,
    config_for,
    write_metrics,
    write_repeat_artifacts,
)
from nclt_slam_tpu_torch.eval.metrics import route_metrics
from nclt_slam_tpu_torch.io.artifacts import (
    load_landmarks_pkl,
    load_teach_map,
    load_vio_pose_dense,
)
from nclt_slam_tpu_torch.planning.dispatcher import subsample_waypoints
from nclt_slam_tpu_torch.rollout.campaign import campaign_device
from nclt_slam_tpu_torch.rollout.repeat import run_repeat
from nclt_slam_tpu_torch.rollout.scene_pack import pack_route, pack_scene
from nclt_slam_tpu_torch.scene import build_drops, default_scene, get_route


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--route", default="03_south")
    ap.add_argument("--teach-dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--mode", default="ours",
                    choices=["ours", "gt", "encoder", "rgbd", "stock"])
    ap.add_argument("--obstacles", action="store_true", default=True)
    ap.add_argument("--no-obstacles", dest="obstacles", action="store_false")
    ap.add_argument("--ticks", type=int, default=12000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--scale", type=float, default=1.0)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    dev = campaign_device(args.device)
    cfg = config_for(args.mode, args.scale)
    route = get_route(args.route)
    drops = build_drops(route) if args.obstacles else None
    scene = batch1(pack_scene(default_scene(), drops, session=1, device=dev))
    packed = batch1(pack_route(route, cfg, dev))

    teach_dir = Path(args.teach_dir)
    grid, _, _ = load_teach_map(teach_dir / "teach_map")
    store = load_landmarks_pkl(teach_dir / "landmarks.pkl", cfg.landmarks,
                               dev)
    dense_gt = load_vio_pose_dense(teach_dir / "vio_pose_dense.csv")
    wps, n_wps = subsample_waypoints(dense_gt, len(dense_gt), cfg.planner)

    print(f"[repeat] {args.route} mode={args.mode} obstacles={args.obstacles} "
          f"wps={n_wps} landmarks={int(store.count[0])}")
    rep = run_repeat(
        scene, packed, torch.from_numpy(grid)[None].to(dev),
        torch.from_numpy(wps)[None].to(dev),
        torch.tensor([n_wps], dtype=torch.int32, device=dev), cfg,
        args.ticks, seed=args.seed, store=store)

    out = write_repeat_artifacts(args.out, rep, cfg)
    gt = rep.trace.gt_xy[0].cpu().numpy()
    nav = rep.trace.nav_xy[0].cpu().numpy()
    m = route_metrics(gt, nav, wps[:n_wps], np.asarray(route.spawn),
                      np.asarray(route.turnaround),
                      wp_tol=cfg.eval.wp_tol_m,
                      endpoint_tol=cfg.eval.endpoint_tol_m,
                      drift_period=cfg.eval.drift_log_period)
    write_metrics(out, m)
    print(f"[repeat] coverage {m['cov_visited']}/{m['cov_total']} "
          f"reach={m['reached_final']} ({m['final_d']:.1f} m) "
          f"return={m['returned_spawn']} ({m['return_d']:.1f} m) "
          f"drift={m['drift_mean']:.2f} m")
    print(f"[repeat] artefacts -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
