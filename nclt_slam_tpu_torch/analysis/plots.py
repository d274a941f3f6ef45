"""Analysis / figure generators (the reference's scripts/analysis zoo;
``nclt_slam_tpu/analysis/plots.py``).

Covers the reference's core thesis-figure types (SURVEY.md §2.1
"Analysis/plots"): scene trajectory maps with obstacles, per-route run
figures (GT vs nav vs teach WPs, anchors, drops), drift-over-time plots,
and the campaign summary table/heatmap.  All functions take in-memory
traces/metrics and write PNGs — no log scraping needed because the rollout
already returns structured trace arrays.  Arrays may be numpy arrays or
tensors on any device: they are moved to the host first.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402


def _np(x) -> np.ndarray:
    """A tensor on any device, or an array-like, as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class SceneView(NamedTuple):
    """The collider slots the plots draw (a packed scene's first fields):
    the scene's colliders, then a route's drop set, which ``drop_mask``
    marks."""

    xy: np.ndarray
    radius: np.ndarray
    valid: np.ndarray
    drop_mask: np.ndarray


def _draw_scene(ax, scene, drops_only=False):
    """Scatter the collider footprints (grey circles; drops in red)."""
    xy = _np(scene.xy)
    r = _np(scene.radius)
    valid = _np(scene.valid)
    drop = _np(scene.drop_mask)
    for i in range(len(xy)):
        if not valid[i]:
            continue
        if drops_only and not drop[i]:
            continue
        color = "#d62728" if drop[i] else "#999999"
        ax.add_patch(plt.Circle(xy[i], r[i], color=color,
                                alpha=0.6 if drop[i] else 0.35, lw=0))


def plot_trajectory_map(scene, routes, out_path, title="routes"):
    """Scene overview with the planned route polylines
    (plot_trajectory_map / routes_plan.png equivalent)."""
    fig, ax = plt.subplots(figsize=(14, 7.5))
    _draw_scene(ax, scene)
    colors = plt.cm.tab20(np.linspace(0, 1, max(len(routes), 2)))
    for route, c in zip(routes, colors):
        pts = _np(route.dense_xy)[: int(route.n_dense)]
        ax.plot(pts[:, 0], pts[:, 1], color=c, lw=1.5,
                label=f"{route.name} ({route.n_dense} wps)")
        ax.plot(*route.spawn, marker="o", color=c, ms=6)
    ax.set_xlim(-110, 85)
    ax.set_ylim(-52, 48)
    ax.set_aspect("equal")
    ax.legend(fontsize=7, ncol=3, loc="lower left")
    ax.set_title(title)
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_route_run(scene, route, trace, wps, n_wps, out_path,
                   title=None):
    """Per-route repeat figure: GT trace vs nav estimate vs teach WPs, drop
    obstacles, anchor events (make_route_video / plot_run equivalent)."""
    gt = _np(trace.gt_xy)
    nav = _np(trace.nav_xy)
    fig, ax = plt.subplots(figsize=(12, 7))
    _draw_scene(ax, scene)
    wp = _np(wps)[: int(n_wps)]
    ax.plot(wp[:, 0], wp[:, 1], "x", color="#2ca02c", ms=5,
            label=f"teach WPs ({len(wp)})")
    ax.plot(gt[:, 0], gt[:, 1], "-", color="#1f77b4", lw=1.2, label="GT")
    ax.plot(nav[:, 0], nav[:, 1], "-", color="#ff7f0e", lw=0.8, alpha=0.8,
            label="nav estimate")
    anchors = _np(trace.anchor_ok)
    if anchors.any():
        ax.plot(gt[anchors, 0], gt[anchors, 1], ".", color="#9467bd", ms=3,
                label=f"anchors ({int(anchors.sum())})")
    ax.plot(*gt[0], marker="o", color="k", ms=7, label="spawn")
    ax.plot(*_np(route.turnaround), marker="*", color="#d62728",
            ms=12, label="turnaround")
    ax.set_aspect("equal")
    ax.legend(fontsize=8)
    ax.set_title(title or f"repeat run — {route.name}")
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_drift(trace, out_path, title="localization drift"):
    """|nav - gt| over time with regime coloring (anchor action/drift plots
    equivalent)."""
    gt = _np(trace.gt_xy)
    nav = _np(trace.nav_xy)
    drift = np.hypot(*(nav - gt).T)
    t = np.arange(len(drift)) * 0.1
    regime = _np(trace.regime)
    fig, ax = plt.subplots(figsize=(11, 3.5))
    ax.plot(t, drift, lw=0.8, color="#444444")
    names = ["no_anchor", "ok", "strong", "encoder"]
    colors = ["#cccccc", "#aec7e8", "#2ca02c", "#ff9896"]
    for r, (nm, c) in enumerate(zip(names, colors)):
        m = regime == r
        if m.any():
            ax.fill_between(t, 0, drift.max() * 1.05, where=m, color=c,
                            alpha=0.25, label=nm)
    ax.set_xlabel("t [s]")
    ax.set_ylabel("drift [m]")
    ax.legend(fontsize=7, ncol=4)
    ax.set_title(title)
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_campaign_summary(per_route: dict, out_path,
                          title="campaign summary"):
    """Route x metric heatmap (aggregate heatmap equivalent)."""
    names = list(per_route)
    cols = ["cov_pct", "final_d", "return_d", "drift_mean"]
    labels = ["coverage %", "reach dist [m]", "return dist [m]",
              "drift mean [m]"]
    data = np.array([[per_route[n].get(c) if per_route[n].get(c) is not None
                      else np.nan for c in cols] for n in names], float)

    fig, axes = plt.subplots(1, len(cols), figsize=(3 * len(cols),
                                                    0.45 * len(names) + 1.5),
                             sharey=True)
    for j, (ax, lab) in enumerate(zip(axes, labels)):
        col = data[:, j:j + 1]
        good_high = j == 0
        im = ax.imshow(col, aspect="auto",
                       cmap="RdYlGn" if good_high else "RdYlGn_r")
        for i, v in enumerate(col[:, 0]):
            if np.isfinite(v):
                ax.text(0, i, f"{v:.1f}", ha="center", va="center",
                        fontsize=8)
        ax.set_xticks([])
        ax.set_title(lab, fontsize=9)
    axes[0].set_yticks(range(len(names)))
    axes[0].set_yticklabels(names, fontsize=8)
    fig.suptitle(title)
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return out_path
