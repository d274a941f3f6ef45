"""Campaign CLI — the run_all_{teach,repeat}.sh + compute_metrics equivalent,
as one batched run (``nclt_slam_tpu/cli/campaign.py``).

    python -m nclt_slam_tpu_torch.cli.campaign --routes all --mode ours --out /tmp/camp

Teaches every route (GT relay config) as one batch, repeats every route
with obstacle drops under the mode's stack as one batch, prints the
reference's per-route + aggregate markdown tables and writes
metrics.json, traces.npz and the teach checkpoint teach_state.ckpt.  Runs
on the CUDA card, or on ``--device cpu``.

``--phase teach`` stops after the teach checkpoint; ``--phase repeat``
resumes from it (in another process, or on another budget).  The
checkpoint is the port's own format (``io/artifacts.py``): a JAX
package's teach_state.ckpt is refused.
"""

from __future__ import annotations

import argparse
import importlib.util
from pathlib import Path

import numpy as np

from nclt_slam_tpu_torch.cli.common import add_device_arg, config_for, write_metrics
from nclt_slam_tpu_torch.io.artifacts import load_checkpoint, save_checkpoint
from nclt_slam_tpu_torch.rollout.campaign import (
    CampaignData,
    build_campaign,
    campaign_device,
    campaign_metrics,
    run_campaign_repeat,
    run_campaign_teach,
    teach_waypoints,
)
from nclt_slam_tpu_torch.scene.routes import ALL_ROUTES

TRACE_KEYS = ("gt_xy", "nav_xy", "regime", "anchor_ok", "wp_idx", "done",
              "fired", "vio_tracked", "vio_flags")


def _take(tree, idx):
    """Index every field of a flat NamedTuple along the route dimension."""
    return type(tree)(*(x[idx] for x in tree))


def slice_routes(data: CampaignData, teach_grid, wps, n_wps, stores, sl):
    """The campaign's inputs restricted to the routes ``sl`` selects."""
    data = CampaignData(scenes_teach=_take(data.scenes_teach, sl),
                        scenes_repeat=_take(data.scenes_repeat, sl),
                        routes=_take(data.routes, sl), names=data.names[sl])
    stores = _take(stores, sl) if stores is not None else None
    return data, teach_grid[sl], wps[sl], n_wps[sl], stores


def tables(per_route: dict, agg: dict) -> str:
    """The reference's per-route and aggregate markdown tables
    (compute_metrics.py main), as the JAX CLI prints them."""
    lines = ["", "# Per-route GT-based metrics", "",
             "| route | coverage | final reach | return | "
             "drift (mean / p95 / max) | GT samples |",
             "|---|---|---|---|---|---|"]
    for name, x in per_route.items():
        cov = (f"{x['cov_visited']}/{x['cov_total']} ({x['cov_pct']:.0f}%)"
               if x["cov_pct"] is not None else "n/a")
        final = (f"**{x['final_d']:.1f} m** "
                 f"{'OK' if x['reached_final'] else 'x'}")
        ret = (f"**{x['return_d']:.1f} m** "
               f"{'OK' if x['returned_spawn'] else 'x'}")
        drift = (f"{x['drift_mean']:.2f} / {x['drift_p95']:.2f} / "
                 f"{x['drift_max']:.2f} m" if x["drift_mean"] is not None
                 else "n/a")
        lines.append(f"| {name} | {cov} | {final} | {ret} | {drift} | "
                     f"{x['gt_samples']} |")
    lines += ["", "# Aggregate", "",
              "| routes | reach | return | full success | avg coverage | "
              "avg drift |",
              "|---|---|---|---|---|---|",
              f"| {agg['routes']} | {agg['reach']}/{agg['routes']} | "
              f"{agg['return']}/{agg['routes']} | "
              f"{agg['full_success']}/{agg['routes']} | "
              f"{agg['avg_coverage_pct']:.0f}% | "
              f"{agg['avg_drift_mean']:.2f} m |"]
    return "\n".join(lines)


def write_traces(out_dir, trace, wps, n_wps, names):
    """traces.npz: the structured trace archive cli.analyze renders the
    figures from (the keys of the JAX CLI's archive)."""
    p = Path(out_dir) / "traces.npz"
    np.savez_compressed(
        p, **{k: np.asarray(getattr(trace, k)) for k in TRACE_KEYS},
        wps=wps.cpu().numpy(), n_wps=n_wps.cpu().numpy(),
        names=np.array(list(names)))
    return p


def write_figures(out_dir, per_route, data: CampaignData, trace, wps,
                  n_wps):
    """Per-route run and drift figures and the summary heatmap; the scenes
    and routes are moved to the host first."""
    from nclt_slam_tpu_torch.analysis import (
        plot_campaign_summary,
        plot_drift,
        plot_route_run,
    )
    from nclt_slam_tpu_torch.analysis.plots import SceneView

    figs = Path(out_dir) / "figures"
    plot_campaign_summary(per_route, figs / "campaign_summary.png")
    # the colliders only: the packed scenes' feature tables stay on the card
    scenes = SceneView(*(getattr(data.scenes_repeat, f).cpu().numpy()
                         for f in SceneView._fields))
    routes = type(data.routes)(*(x.cpu() for x in data.routes))
    wps, n_wps = wps.cpu().numpy(), n_wps.cpu().numpy()
    for i, name in enumerate(data.names):
        tr_i = _take(trace, i)
        sc_i = _take(scenes, i)
        rt_i = _take(routes, i)

        class _R:  # route-view for the plotting API
            dense_xy = rt_i.dense_xy.numpy()
            n_dense = int(rt_i.n_dense)
            spawn = tuple(map(float, rt_i.spawn))
            turnaround = tuple(map(float, rt_i.turnaround))
            name = data.names[i]

        plot_route_run(sc_i, _R, tr_i, wps[i], int(n_wps[i]),
                       figs / f"run_{name}.png")
        plot_drift(tr_i, figs / f"drift_{name}.png",
                   title=f"drift — {name}")
    return figs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--routes", default="all",
                    help="'all' or comma-separated route names")
    ap.add_argument("--mode", default="ours",
                    choices=["ours", "gt", "encoder", "rgbd", "stock"])
    ap.add_argument("--out", required=True)
    ap.add_argument("--teach-ticks", type=int, default=12000)
    ap.add_argument("--repeat-ticks", type=int, default=12000)
    ap.add_argument("--no-obstacles", dest="obstacles", action="store_false",
                    default=True)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--figures", action="store_true",
                    help="render per-route run figures + summary heatmap")
    ap.add_argument("--route-slice", default=None,
                    help="A:B batch slice for the repeat phase")
    ap.add_argument("--phase", default="both",
                    choices=["both", "teach", "repeat"],
                    help="run one phase and checkpoint (the phases can "
                         "run as separate processes)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    if args.figures and importlib.util.find_spec("matplotlib") is None:
        # fail before the run, not after it (matplotlib is an optional
        # dependency: the card's machine may lack it)
        ap.error("--figures needs matplotlib")

    dev = campaign_device(args.device)
    names = ALL_ROUTES if args.routes == "all" else args.routes.split(",")
    cfg_teach = config_for("gt", args.scale)
    cfg = config_for(args.mode, args.scale)

    print(f"[campaign] {len(names)} routes, mode={args.mode}", flush=True)
    data = build_campaign(names, cfg=cfg, with_drops=args.obstacles,
                          device=dev)

    def prog(tag):
        def f(done_ticks, total, n_done):
            print(f"[campaign] {tag} {done_ticks}/{total} ticks, "
                  f"{n_done}/{len(names)} routes complete", flush=True)
        return f

    ckpt = Path(args.out) / "teach_state.ckpt"
    if args.phase in ("both", "teach"):
        teach = run_campaign_teach(data, cfg_teach, args.teach_ticks,
                                   progress=prog("teach"))
        wps, n_wps = teach_waypoints(data, teach, cfg)
        save_checkpoint(
            {"grid": teach.teach_grid, "store": teach.store,
             "wps": wps, "n_wps": n_wps}, ckpt)
        print(f"[campaign] teach checkpoint -> {ckpt}", flush=True)
        if args.phase == "teach":
            return 0
        teach_grid, stores = teach.teach_grid, teach.store
    else:
        blob = load_checkpoint(ckpt, dev)
        teach_grid, stores = blob["grid"], blob["store"]
        wps, n_wps = blob["wps"], blob["n_wps"]
        print(f"[campaign] teach checkpoint loaded <- {ckpt}", flush=True)

    if args.mode == "gt":
        stores = None
    if args.route_slice:
        a, b = (int(v) if v else None for v in args.route_slice.split(":"))
        data, teach_grid, wps, n_wps, stores = slice_routes(
            data, teach_grid, wps, n_wps, stores, slice(a, b))
        names = list(data.names)
        print(f"[campaign] repeat slice {args.route_slice}: {names}",
              flush=True)
    rep = run_campaign_repeat(data, teach_grid, wps, n_wps, cfg,
                              args.repeat_ticks, stores=stores,
                              progress=prog("repeat"))

    per_route, agg = campaign_metrics(data, rep, wps, n_wps, cfg)
    print(tables(per_route, agg))

    p = write_metrics(args.out, {"per_route": per_route, "aggregate": agg})
    print(f"\n(machine-readable -> {p})")
    p = write_traces(args.out, rep.trace, wps, n_wps, data.names)
    print(f"(traces -> {p})")

    if args.figures:
        figs = write_figures(args.out, per_route, data, rep.trace, wps, n_wps)
        print(f"[campaign] figures -> {figs}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
