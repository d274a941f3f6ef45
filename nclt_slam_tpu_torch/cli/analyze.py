"""Analysis CLI — renders the full thesis-figure set from campaign outputs
(``nclt_slam_tpu/cli/analyze.py``).

Single-campaign summary:

    python -m nclt_slam_tpu_torch.cli.analyze --metrics runs/c/metrics.json --out figs

Multi-stack comparison zoo (aggregate + per-group heatmaps, three-way
trajectory figures, per-route READMEs) from several campaign dirs, each
produced by ``cli.campaign --mode <stack> --out <dir>``:

    python -m nclt_slam_tpu_torch.cli.analyze \
        --campaigns ours=runs/ours,rgbd=runs/rgbd,stock=runs/stock --out figs

Route replay animations (GIF):

    python -m nclt_slam_tpu_torch.cli.analyze --campaigns ours=runs/ours \
        --animate 03_south --out figs

Dev-history across a chronological run sequence:

    python -m nclt_slam_tpu_torch.cli.analyze \
        --history r1=artifacts/campaign_v2,r2=runs/ours --out figs

Scene/route overview map (no campaign data needed):

    python -m nclt_slam_tpu_torch.cli.analyze --overview --out figs

It takes no ``--device``: it does no device work.  It reads the campaign
directories' metrics.json and traces.npz (numpy) and draws the scene's
colliders and routes on the host, with each route's drop set as a
host-side mask over the collider slots.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from nclt_slam_tpu_torch.analysis.plots import SceneView
from nclt_slam_tpu_torch.scene import build_drops, default_scene, get_route, no_drops
from nclt_slam_tpu_torch.scene.routes import ALL_ROUTES


def scene_view(scene, drops=None) -> SceneView:
    """The scene's colliders and a route's drops laid out as ``pack_scene``
    lays them, on the host (no feature points: nothing is packed)."""
    drops = no_drops() if drops is None else drops
    return SceneView(
        xy=np.concatenate([scene.xy, drops.xy], 0),
        radius=np.concatenate([scene.radius, drops.radius], 0),
        valid=np.concatenate([scene.valid, drops.valid], 0),
        drop_mask=np.concatenate([np.zeros(len(scene.xy), bool),
                                  np.ones(len(drops.xy), bool)], 0))


def _load_campaigns(spec: str):
    """'label=dir,label=dir' -> {label: {'metrics':…, 'traces':… or None}}"""
    out = {}
    for part in spec.split(","):
        label, d = part.split("=", 1)
        d = Path(d)
        blob = json.loads((d / "metrics.json").read_text())
        traces = None
        tp = d / "traces.npz"
        if tp.exists():
            traces = np.load(tp, allow_pickle=False)
        out[label] = {"metrics": blob.get("per_route", blob),
                      "aggregate": blob.get("aggregate"),
                      "traces": traces}
    return out


def _route_trace(traces, name):
    """Per-route view dict from the stacked traces.npz."""
    names = [str(n) for n in traces["names"]]
    if name not in names:
        return None
    i = names.index(name)
    return {k: traces[k][i] for k in
            ("gt_xy", "nav_xy", "regime", "anchor_ok", "wp_idx", "done",
             "fired")}, traces["wps"][i], int(traces["n_wps"][i])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--metrics", default=None,
                    help="single campaign metrics.json to summarize")
    ap.add_argument("--campaigns", default=None,
                    help="label=dir[,label=dir…] multi-stack comparison")
    ap.add_argument("--history", default=None,
                    help="label=dir[,label=dir…] chronological dev history")
    ap.add_argument("--animate", default=None,
                    help="comma list of routes to render replay GIFs for "
                         "(uses the FIRST --campaigns entry's traces)")
    ap.add_argument("--routes", default=None,
                    help="restrict three-way/README generation to these")
    ap.add_argument("--overview", action="store_true",
                    help="render the scene + route overview map")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    if args.overview:
        from nclt_slam_tpu_torch.analysis import plot_trajectory_map

        scene = scene_view(default_scene())
        routes = [get_route(n) for n in ALL_ROUTES]
        p = plot_trajectory_map(scene, routes, out / "routes_overview.png",
                                title="all 15 routes over the forest scene")
        print(f"[analyze] {p}")

    if args.metrics:
        from nclt_slam_tpu_torch.analysis import plot_campaign_summary

        blob = json.loads(Path(args.metrics).read_text())
        per_route = blob.get("per_route", blob)
        p = plot_campaign_summary(per_route, out / "campaign_summary.png")
        print(f"[analyze] {p}")
        agg = blob.get("aggregate")
        if agg:
            print(f"[analyze] aggregate: {agg}")

    if args.campaigns:
        from nclt_slam_tpu_torch.analysis.campaign_figures import (
            gen_route_readme,
            make_route_animation,
            plot_aggregate_heatmap,
            plot_route_group_heatmaps,
            plot_three_way,
        )

        camps = _load_campaigns(args.campaigns)
        metrics_by_stack = {k: v["metrics"] for k, v in camps.items()}

        p = plot_aggregate_heatmap(metrics_by_stack,
                                   out / "heatmap_aggregate.png")
        print(f"[analyze] {p}")
        for p in plot_route_group_heatmaps(metrics_by_stack,
                                           out / "route_groups"):
            print(f"[analyze] {p}")

        # three-way trajectory figures + per-route READMEs need scene + traces
        with_traces = {k: v for k, v in camps.items()
                       if v["traces"] is not None}
        all_routes = sorted({r for m in metrics_by_stack.values() for r in m})
        sel_routes = (args.routes.split(",") if args.routes else all_routes)
        if with_traces:
            scene_raw = default_scene(7)
            for rname in sel_routes:
                per_stack_traces = {}
                wps = n_wps = None
                for stack, v in with_traces.items():
                    rt = _route_trace(v["traces"], rname)
                    if rt is not None:
                        per_stack_traces[stack], wps, n_wps = rt
                if not per_stack_traces:
                    continue
                route = get_route(rname, 7)
                scene = scene_view(scene_raw, build_drops(route))

                class _RV:
                    name = rname
                    spawn = route.spawn
                    turnaround = route.turnaround

                fig = plot_three_way(scene, _RV, per_stack_traces, wps, n_wps,
                                     out / "routes" / rname /
                                     f"three_way_{rname}.png")
                gen_route_readme(rname, metrics_by_stack,
                                 out / "routes" / rname, route_view=_RV,
                                 figures=[fig])
                print(f"[analyze] routes/{rname}")

        if args.animate:
            first = next(iter(with_traces.values()), None)
            if first is None:
                print("[analyze] --animate needs traces.npz in a campaign dir")
            else:
                scene_raw = default_scene(7)
                for rname in args.animate.split(","):
                    rt = _route_trace(first["traces"], rname)
                    if rt is None:
                        continue
                    trace, wps, n_wps = rt
                    route = get_route(rname, 7)
                    scene = scene_view(scene_raw, build_drops(route))

                    class _RV:
                        name = rname
                        spawn = route.spawn
                        turnaround = route.turnaround

                    p = make_route_animation(
                        scene, _RV, trace, wps, n_wps,
                        out / f"replay_{rname}.gif")
                    print(f"[analyze] {p}")

    if args.history:
        from nclt_slam_tpu_torch.analysis.campaign_figures import plot_dev_history

        hist = []
        for part in args.history.split(","):
            label, d = part.split("=", 1)
            blob = json.loads((Path(d) / "metrics.json").read_text())
            hist.append((label, blob["aggregate"]))
        p = plot_dev_history(hist, out / "dev_history.png")
        print(f"[analyze] {p}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
