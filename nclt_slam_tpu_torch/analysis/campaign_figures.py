"""Campaign-level thesis figure zoo (``nclt_slam_tpu/analysis/campaign_figures.py``).

Re-creates the reference's scripts/analysis generators on top of our
structured campaign outputs (metrics.json + traces.npz) instead of log
scraping:

- aggregate route-group heatmap (make_aggregate_heatmap.py): 6 groups x
  N stacks, panels for coverage / reach / return, group-mean cells
- per-group heatmaps (make_route_group_heatmaps.py): routes x stacks with
  the same smooth green->red gradient per metric
- three-way trajectory comparison (plot_three_way.py): all stacks' GT
  traces on one scene map
- per-route README generator (gen_route_readme.py)
- route replay animation (make_route_video.py; GIF via Pillow since the
  image has no ffmpeg) with live drift / WP / goal HUD
- dev-history plot (make_dev_history_plots.py): aggregate metrics across
  a sequence of campaign runs

Arrays may be numpy arrays or tensors on any device (moved to the host
first).
"""

from __future__ import annotations

from pathlib import Path

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
from matplotlib.colors import LinearSegmentedColormap, Normalize  # noqa: E402

from nclt_slam_tpu_torch.analysis.plots import _draw_scene, _np  # noqa: E402

# same 6 route groups as make_aggregate_heatmap.py:30-45
ROUTE_GROUPS = [
    ("G1 forest", ["02_north_forest", "03_south", "04_nw_se", "05_ne_sw",
                   "06_nw_ne", "07_se_sw", "08_nw_sw", "11_nw_mid",
                   "13_cross_nws", "15_wmid_smid"]),
    ("G2 open", ["01_road", "09_se_ne", "10_nmid_smid", "12_ne_mid",
                 "14_se_mid"]),
    ("G3 short", ["08_nw_sw", "09_se_ne", "10_nmid_smid", "11_nw_mid",
                  "12_ne_mid", "13_cross_nws", "14_se_mid", "15_wmid_smid"]),
    ("G4 long", ["01_road", "02_north_forest", "03_south", "04_nw_se",
                 "05_ne_sw", "06_nw_ne", "07_se_sw"]),
    ("G5 cones+tent", ["01_road", "02_north_forest", "03_south", "04_nw_se"]),
    ("G6 mixed props", ["05_ne_sw", "06_nw_ne", "07_se_sw", "08_nw_sw",
                        "09_se_ne", "10_nmid_smid", "11_nw_mid", "12_ne_mid",
                        "13_cross_nws", "14_se_mid", "15_wmid_smid"]),
]

STACK_COLORS = {
    "ours": "#1f77b4",
    "rgbd": "#ff7f0e",
    "encoder": "#2ca02c",
    "stock": "#d62728",
    "gt": "#9467bd",
}


def _grad(points):
    """Smooth gradient colormap through (value01, color) control points
    (make_route_group_heatmaps.py gradient style)."""
    vals = [p[0] for p in points]
    cols = [p[1] for p in points]
    return LinearSegmentedColormap.from_list("g", list(zip(vals, cols)))


# distance metrics: 0 deep green -> 5 lime -> 10 yellow -> 20 orange -> 30 red
_DIST_CMAP = _grad([(0.0, "#1a7a2e"), (5 / 30, "#8bc34a"),
                    (10 / 30, "#ffd54f"), (20 / 30, "#ff8a30"),
                    (1.0, "#c62828")])
_DIST_NORM = Normalize(0.0, 30.0, clip=True)
# coverage: 0 red -> 100 green
_COV_CMAP = _grad([(0.0, "#c62828"), (0.5, "#ffd54f"), (1.0, "#1a7a2e")])
_COV_NORM = Normalize(0.0, 100.0, clip=True)

# (field, label, cmap, norm)
_PANELS = [
    ("cov_pct", "WP coverage [%]", _COV_CMAP, _COV_NORM),
    ("final_d", "reach dist [m]", _DIST_CMAP, _DIST_NORM),
    ("return_d", "return dist [m]", _DIST_CMAP, _DIST_NORM),
    ("drift_mean", "drift mean [m]", _DIST_CMAP, Normalize(0, 10, clip=True)),
]


def _cell_text(ax, j, i, v):
    if v is None or not np.isfinite(v):
        ax.text(j, i, "–", ha="center", va="center", fontsize=8, color="#888")
    else:
        ax.text(j, i, f"{v:.1f}", ha="center", va="center", fontsize=8)


def _panel(ax, rows, stacks, values, label, cmap, norm, ylabels=True):
    """rows x stacks matrix panel with value text."""
    data = np.array([[np.nan if v is None else v for v in row]
                     for row in values], float)
    ax.imshow(np.where(np.isfinite(data), data, norm.vmax), aspect="auto",
              cmap=cmap, norm=norm)
    for i in range(len(rows)):
        for j in range(len(stacks)):
            _cell_text(ax, j, i, data[i, j])
    ax.set_xticks(range(len(stacks)))
    ax.set_xticklabels(stacks, fontsize=8, rotation=30, ha="right")
    if ylabels:
        ax.set_yticks(range(len(rows)))
        ax.set_yticklabels(rows, fontsize=8)
    else:
        ax.set_yticks([])
    ax.set_title(label, fontsize=9)


def plot_aggregate_heatmap(metrics_by_stack: dict, out_path,
                           panels=("cov_pct", "final_d", "return_d")):
    """Group-mean heatmap: 6 route groups x stacks, one panel per metric
    (make_aggregate_heatmap.py equivalent)."""
    stacks = list(metrics_by_stack)
    panel_defs = [p for p in _PANELS if p[0] in panels]
    fig, axes = plt.subplots(
        1, len(panel_defs),
        figsize=(1.1 * len(stacks) * len(panel_defs) + 3,
                 0.55 * len(ROUTE_GROUPS) + 1.8))
    if len(panel_defs) == 1:
        axes = [axes]
    group_names = [g for g, _ in ROUTE_GROUPS]
    for k, (field, label, cmap, norm) in enumerate(panel_defs):
        values = []
        for _, routes in ROUTE_GROUPS:
            row = []
            for s in stacks:
                per = metrics_by_stack[s]
                vs = [per[r][field] for r in routes
                      if r in per and per[r].get(field) is not None]
                row.append(float(np.mean(vs)) if vs else None)
            values.append(row)
        _panel(axes[k], group_names, stacks, values, label, cmap, norm,
               ylabels=(k == 0))
    fig.suptitle("aggregated metrics per route group (mean over routes)",
                 fontsize=11)
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_route_group_heatmaps(metrics_by_stack: dict, out_dir):
    """One heatmap per route group: routes x stacks, 4 metric panels
    (make_route_group_heatmaps.py equivalent)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    stacks = list(metrics_by_stack)
    outs = []
    for gname, routes in ROUTE_GROUPS:
        present = [r for r in routes
                   if any(r in metrics_by_stack[s] for s in stacks)]
        if not present:
            continue
        fig, axes = plt.subplots(
            1, len(_PANELS),
            figsize=(1.1 * len(stacks) * len(_PANELS) + 3,
                     0.5 * len(present) + 1.8))
        for k, (field, label, cmap, norm) in enumerate(_PANELS):
            values = [[metrics_by_stack[s].get(r, {}).get(field)
                       for s in stacks] for r in present]
            _panel(axes[k], present, stacks, values, label, cmap, norm,
                   ylabels=(k == 0))
        fig.suptitle(f"route group {gname}", fontsize=11)
        slug = gname.split()[0].lower()
        p = out_dir / f"heatmap_{slug}.png"
        fig.savefig(p, dpi=130, bbox_inches="tight")
        plt.close(fig)
        outs.append(p)
    return outs


def plot_three_way(scene, route_view, traces_by_stack: dict, wps, n_wps,
                   out_path):
    """All stacks' GT trajectories on one scene map (plot_three_way.py —
    'the main figure that goes into the thesis')."""
    fig, ax = plt.subplots(figsize=(13, 7))
    _draw_scene(ax, scene)
    wp = _np(wps)[: int(n_wps)]
    ax.plot(wp[:, 0], wp[:, 1], "x", color="#555555", ms=4,
            label=f"teach WPs ({len(wp)})")
    for stack, trace in traces_by_stack.items():
        gt = _np(trace["gt_xy"])
        done = _np(trace.get("done", np.zeros(len(gt), bool)))
        live = ~done
        ax.plot(gt[live, 0], gt[live, 1], "-",
                color=STACK_COLORS.get(stack, None), lw=1.3, label=stack)
    ax.plot(*_np(route_view.spawn), marker="o", color="k", ms=8,
            label="spawn")
    ax.plot(*_np(route_view.turnaround), marker="*", color="#d62728",
            ms=14, label="turnaround")
    ax.set_aspect("equal")
    ax.legend(fontsize=8, ncol=2)
    ax.set_title(f"stack comparison — {route_view.name}")
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return out_path


def gen_route_readme(route_name: str, metrics_by_stack: dict, out_dir,
                     route_view=None, figures: list | None = None):
    """Markdown README per route stitching teach + repeat + per-stack
    metrics together (gen_route_readme.py equivalent)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    lines = [f"# Route {route_name}", ""]
    if route_view is not None:
        sp = _np(route_view.spawn)
        tn = _np(route_view.turnaround)
        length = float(np.hypot(*(tn - sp)))
        lines += [
            f"- spawn: ({sp[0]:.1f}, {sp[1]:.1f})",
            f"- turnaround: ({tn[0]:.1f}, {tn[1]:.1f})",
            f"- straight-line leg: {length:.0f} m",
            "",
        ]
    lines += ["## Repeat results by stack", "",
              "| stack | coverage | reach | return | "
              "drift mean / p95 / max |",
              "|---|---|---|---|---|"]
    for stack, per in metrics_by_stack.items():
        x = per.get(route_name)
        if x is None:
            continue
        cov = (f"{x['cov_visited']}/{x['cov_total']} ({x['cov_pct']:.0f}%)"
               if x.get("cov_pct") is not None else "n/a")
        reach = f"{x['final_d']:.1f} m {'OK' if x['reached_final'] else 'x'}"
        ret = f"{x['return_d']:.1f} m {'OK' if x['returned_spawn'] else 'x'}"
        drift = (f"{x['drift_mean']:.2f} / {x['drift_p95']:.2f} / "
                 f"{x['drift_max']:.2f} m"
                 if x.get("drift_mean") is not None else "n/a")
        lines.append(f"| {stack} | {cov} | {reach} | {ret} | {drift} |")
    if figures:
        lines += ["", "## Figures", ""]
        lines += [f"![{Path(f).stem}]({Path(f).name})" for f in figures]
    p = out_dir / "README.md"
    p.write_text("\n".join(lines) + "\n")
    return p


def make_route_animation(scene, route_view, trace, wps, n_wps, out_path,
                         stride: int = 25, fps: int = 12, trail: int = 4000):
    """Animated top-down replay with the reference video's HUD overlays
    (make_route_video.py equivalent; GIF because the image has no ffmpeg):
    live drift, WPs reached, distance driven, current goal phase."""
    from matplotlib.animation import FuncAnimation, PillowWriter

    gt = _np(trace["gt_xy"])
    nav = _np(trace["nav_xy"])
    done = _np(trace.get("done", np.zeros(len(gt), bool)))
    wp_idx = _np(trace.get("wp_idx", np.zeros(len(gt), np.int32)))
    fired = _np(trace.get("fired", np.zeros(len(gt), bool)))
    n_live = int((~done).sum()) or len(gt)
    frames = list(range(0, n_live, stride))

    fig, ax = plt.subplots(figsize=(10, 6))
    _draw_scene(ax, scene)
    wp = _np(wps)[: int(n_wps)]
    ax.plot(wp[:, 0], wp[:, 1], "x", color="#2ca02c", ms=4)
    ax.plot(*_np(route_view.turnaround), marker="*", color="#d62728",
            ms=12)
    (gt_line,) = ax.plot([], [], "-", color="#1f77b4", lw=1.4)
    (nav_line,) = ax.plot([], [], "-", color="#ff7f0e", lw=0.9, alpha=0.85)
    (dot,) = ax.plot([], [], "o", color="k", ms=6)
    hud = ax.text(0.01, 0.99, "", transform=ax.transAxes, va="top",
                  fontsize=9, family="monospace",
                  bbox=dict(fc="white", alpha=0.8, lw=0))
    ax.set_aspect("equal")
    ax.set_title(f"repeat replay — {route_view.name}")

    seg = np.hypot(*np.diff(gt, axis=0).T)
    dist_cum = np.concatenate([[0.0], np.cumsum(seg)])

    def update(f):
        a = max(0, f - trail)
        gt_line.set_data(gt[a:f + 1, 0], gt[a:f + 1, 1])
        nav_line.set_data(nav[a:f + 1, 0], nav[a:f + 1, 1])
        dot.set_data([gt[f, 0]], [gt[f, 1]])
        drift = float(np.hypot(*(nav[f] - gt[f])))
        goal = "-> turnaround" if not fired[f] else "<- returning to spawn"
        hud.set_text(
            f"t={f * 0.1:7.1f}s  err={drift:5.2f}m\n"
            f"wp {int(wp_idx[f])}/{int(n_wps)}  "
            f"driven {dist_cum[f]:6.1f}m\n{goal}")
        return gt_line, nav_line, dot, hud

    anim = FuncAnimation(fig, update, frames=frames, blit=True)
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    anim.save(out_path, writer=PillowWriter(fps=fps))
    plt.close(fig)
    return out_path


def plot_dev_history(history: list, out_path,
                     title="campaign development history"):
    """Aggregate metrics over a sequence of campaign runs
    (make_dev_history_plots.py equivalent for our run-based history).

    history: list of (label, aggregate_dict) in chronological order."""
    labels = [h[0] for h in history]
    aggs = [h[1] for h in history]
    x = np.arange(len(history))
    fig, axes = plt.subplots(1, 3, figsize=(14, 3.6))
    routes = np.array([a.get("routes", 15) for a in aggs], float)

    axes[0].plot(x, [a["reach"] for a in aggs], "o-", label="reach")
    axes[0].plot(x, [a["return"] for a in aggs], "s-", label="return")
    axes[0].plot(x, [a["full_success"] for a in aggs], "^-",
                 label="full success")
    axes[0].plot(x, routes, ":", color="#888", label="route count")
    axes[0].set_ylabel("routes")
    axes[0].legend(fontsize=8)

    axes[1].plot(x, [a["avg_coverage_pct"] for a in aggs], "o-",
                 color="#2ca02c")
    axes[1].set_ylabel("avg coverage [%]")
    axes[1].set_ylim(0, 105)

    axes[2].plot(x, [a["avg_drift_mean"] for a in aggs], "o-",
                 color="#d62728")
    axes[2].set_ylabel("avg drift mean [m]")

    for ax in axes:
        ax.set_xticks(x)
        ax.set_xticklabels(labels, rotation=30, ha="right", fontsize=8)
        ax.grid(alpha=0.3)
    fig.suptitle(title)
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return out_path
