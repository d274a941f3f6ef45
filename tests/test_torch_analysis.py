"""The port's analysis zoo, analysis CLI and profiling utilities
(``nclt_slam_tpu_torch/{analysis,cli/analyze.py,utils}``) on the synthetic
campaign stacks of ``tests/test_analysis.py``, against the JAX package's:
every figure generator and its JAX counterpart, fed the same inputs, render
the same decoded pixels (PNG) or frames (GIF), also when the port is fed
tensors; the generated route README is JAX's text, ``rollout_stats`` gives
JAX's statistics, and ``cli.analyze`` writes the same files as JAX's
``cli.analyze`` run with the same arguments."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from test_analysis import ROUTES, _fake_trace, _RV, _Scene, fake_route_metrics  # noqa: E402

from PIL import Image, ImageSequence  # noqa: E402

import nclt_slam_tpu.analysis as J  # noqa: E402
from nclt_slam_tpu.utils import rollout_stats as j_rollout_stats  # noqa: E402
from nclt_slam_tpu_torch.analysis import (  # noqa: E402
    ROUTE_GROUPS,
    gen_route_readme,
    make_route_animation,
    plot_aggregate_heatmap,
    plot_campaign_summary,
    plot_dev_history,
    plot_drift,
    plot_route_group_heatmaps,
    plot_route_run,
    plot_three_way,
    plot_trajectory_map,
)
from nclt_slam_tpu_torch.utils import RateCounter, profile_trace, rollout_stats  # noqa: E402


@pytest.fixture()
def stacks():
    rng = np.random.RandomState(0)
    return {
        "ours": {r: fake_route_metrics(rng, good=True) for r in ROUTES},
        "stock": {r: fake_route_metrics(rng, good=False) for r in ROUTES},
    }


def tensors(d: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


class _TensorScene:
    xy = torch.from_numpy(_Scene.xy)
    radius = torch.from_numpy(_Scene.radius)
    valid = torch.from_numpy(_Scene.valid)
    drop_mask = torch.from_numpy(_Scene.drop_mask)


def frames(path) -> list[np.ndarray]:
    """The decoded RGBA frames of a PNG (one) or a GIF."""
    with Image.open(path) as im:
        return [np.asarray(f.convert("RGBA")).copy()
                for f in ImageSequence.Iterator(im)]


def assert_same_image(p, q):
    """``p`` and ``q`` decode to the same pixels, and draw something."""
    a, b = frames(p), frames(q)
    assert len(a) == len(b), (p, len(a), len(b))
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.shape == y.shape, (p, i, x.shape, y.shape)
        assert np.array_equal(x, y), (p, i, int((x != y).any(-1).sum()))
    assert len(np.unique(a[0].reshape(-1, 4), axis=0)) > 2, p


def wps8():
    wps = np.zeros((8, 2), np.float32)
    wps[:, 0] = np.arange(8) * 4.0
    return wps


def test_aggregate_heatmap(tmp_path, stacks):
    p = plot_aggregate_heatmap(stacks, tmp_path / "agg.png")
    q = J.plot_aggregate_heatmap(stacks, tmp_path / "jax_agg.png")
    assert p.exists() and p.stat().st_size > 5000
    assert_same_image(p, q)


def test_route_group_heatmaps(tmp_path, stacks):
    outs = plot_route_group_heatmaps(stacks, tmp_path / "groups")
    j_outs = J.plot_route_group_heatmaps(stacks, tmp_path / "jax_groups")
    expected = sum(1 for _, rs in ROUTE_GROUPS
                   if any(r in rs for r in ROUTES))
    assert len(outs) == expected
    assert [p.name for p in outs] == [q.name for q in j_outs]
    for p, q in zip(outs, j_outs):
        assert_same_image(p, q)


@pytest.mark.parametrize("as_tensors", [False, True])
def test_three_way(tmp_path, as_tensors):
    traces = {"ours": _fake_trace(), "stock": _fake_trace()}
    q = J.plot_three_way(_Scene, _RV, traces, wps8(), 8,
                         tmp_path / "jax_3w.png")
    scene, wps = _Scene, wps8()
    if as_tensors:
        traces = {k: tensors(v) for k, v in traces.items()}
        scene, wps = _TensorScene, torch.from_numpy(wps)
    p = plot_three_way(scene, _RV, traces, wps, 8, tmp_path / "3w.png")
    assert p.exists() and p.stat().st_size > 5000
    assert_same_image(p, q)


def test_route_readme_is_jax_text(tmp_path, stacks):
    p = gen_route_readme("03_south", stacks, tmp_path / "port",
                         route_view=_RV, figures=["three_way.png"])
    q = J.gen_route_readme("03_south", stacks, tmp_path / "jax",
                           route_view=_RV, figures=["three_way.png"])
    text = p.read_text()
    assert text == q.read_text()
    assert "# Route 03_south" in text
    assert "| ours |" in text and "| stock |" in text


@pytest.mark.parametrize("as_tensors", [False, True])
def test_route_animation(tmp_path, as_tensors):
    trace, scene, wps = _fake_trace(), _Scene, wps8()
    q = J.make_route_animation(scene, _RV, trace, wps, 8,
                               tmp_path / "jax_replay.gif", stride=60, fps=5)
    if as_tensors:
        trace, scene, wps = tensors(trace), _TensorScene, torch.from_numpy(wps)
    p = make_route_animation(scene, _RV, trace, wps, 8,
                             tmp_path / "replay.gif", stride=60, fps=5)
    assert p.exists() and p.stat().st_size > 10000
    assert len(frames(p)) > 1
    assert_same_image(p, q)


def test_dev_history(tmp_path):
    hist = [
        ("r1", {"routes": 15, "reach": 13, "return": 6, "full_success": 6,
                "avg_coverage_pct": 88.0, "avg_drift_mean": 0.9}),
        ("r2", {"routes": 15, "reach": 15, "return": 15, "full_success": 15,
                "avg_coverage_pct": 99.0, "avg_drift_mean": 0.4}),
    ]
    p = plot_dev_history(hist, tmp_path / "hist.png")
    q = J.plot_dev_history(hist, tmp_path / "jax_hist.png")
    assert p.exists() and p.stat().st_size > 5000
    assert_same_image(p, q)


class _Trace:
    """A RepeatTrace-like view with tensor fields."""

    def __init__(self, d):
        for k, v in d.items():
            setattr(self, k, torch.from_numpy(np.asarray(v)))


class _NpTrace:
    """A RepeatTrace-like view with numpy fields."""

    def __init__(self, d):
        for k, v in d.items():
            setattr(self, k, np.asarray(v))


@pytest.mark.parametrize("as_tensors", [False, True])
def test_route_run_drift_and_summary_from_tensors(tmp_path, stacks,
                                                  as_tensors):
    raw = _fake_trace()
    raw["regime"] = np.random.RandomState(4).randint(0, 4, len(raw["gt_xy"]))
    raw["anchor_ok"] = raw["wp_idx"] % 3 == 0
    tr, scene, wps = _NpTrace(raw), _Scene, wps8()
    j = (J.plot_route_run(scene, _RV, tr, wps, 8, tmp_path / "jax_run.png"),
         J.plot_drift(tr, tmp_path / "jax_drift.png"),
         J.plot_campaign_summary(stacks["ours"], tmp_path / "jax_sum.png"))
    if as_tensors:
        tr, scene, wps = _Trace(raw), _TensorScene, torch.from_numpy(wps)
    p = plot_route_run(scene, _RV, tr, wps, 8, tmp_path / "run.png")
    q = plot_drift(tr, tmp_path / "drift.png")
    s = plot_campaign_summary(stacks["ours"], tmp_path / "summary.png")
    assert all(x.exists() and x.stat().st_size > 5000 for x in (p, q, s))
    for x, y in zip((p, q, s), j):
        assert_same_image(x, y)


def test_rollout_stats_match_jax():
    raw = _fake_trace()
    raw["regime"] = np.random.RandomState(4).randint(-1, 4, len(raw["gt_xy"]))
    raw["vio_tracked"] = np.arange(len(raw["gt_xy"])) - 5
    raw["anchor_ok"] = raw["wp_idx"] % 3 == 0
    assert rollout_stats(_Trace(raw)) == j_rollout_stats(
        type("T", (), raw)())


def test_rate_counter_and_profile_trace(tmp_path):
    logs = []
    rc = RateCounter("ticks", report_every=0.0)
    rc.add(5, log=logs.append)
    assert rc.count == 5 and rc.rate > 0 and logs and "ticks" in logs[0]
    with profile_trace(tmp_path / "trace") as prof:
        torch.ones(64).cumsum(0)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert any("cumsum" in e.key for e in prof.key_averages())


def campaign_dirs(tmp_path, stacks):
    """Campaign directories as cli.campaign writes them: metrics.json, and
    for "ours" a traces.npz of two routes."""
    for stack, per in stacks.items():
        d = tmp_path / stack
        d.mkdir()
        agg = {"routes": len(ROUTES), "reach": 3, "return": 2,
               "full_success": 2, "avg_coverage_pct": 80.0,
               "avg_drift_mean": 1.0}
        (d / "metrics.json").write_text(
            json.dumps({"per_route": per, "aggregate": agg}))
    tr = [_fake_trace(), _fake_trace()]
    keys = ("gt_xy", "nav_xy", "regime", "anchor_ok", "wp_idx", "done",
            "fired")
    np.savez_compressed(
        tmp_path / "ours" / "traces.npz",
        **{k: np.stack([t[k] for t in tr]) for k in keys},
        wps=np.stack([wps8(), wps8()]), n_wps=np.array([8, 8]),
        names=np.array(["03_south", "09_se_ne"]))


def assert_same_outputs(out, j_out):
    """Two analysis output trees hold the same files: equal text, and images
    that decode to the same pixels."""
    files = sorted(p.relative_to(out) for p in out.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(j_out) for p in j_out.rglob("*")
                           if p.is_file())
    for rel in files:
        if rel.suffix in (".png", ".gif"):
            assert_same_image(out / rel, j_out / rel)
        else:
            assert (out / rel).read_text() == (j_out / rel).read_text(), rel


def test_analyze_cli_end_to_end(tmp_path, stacks):
    """cli.analyze regenerates the comparison set, the three-way figures and
    READMEs, replay GIFs and the dev history from campaign directories, and
    writes what JAX's cli.analyze writes with the same arguments."""
    from nclt_slam_tpu.cli.analyze import main as j_main
    from nclt_slam_tpu_torch.cli.analyze import main

    campaign_dirs(tmp_path, stacks)
    out = tmp_path / "figs"
    argv = ["--campaigns",
            f"ours={tmp_path / 'ours'},stock={tmp_path / 'stock'}",
            "--history",
            f"r1={tmp_path / 'stock'},r2={tmp_path / 'ours'}",
            "--routes", "03_south", "--animate", "03_south",
            "--metrics", str(tmp_path / "ours" / "metrics.json")]
    rc = main(argv + ["--out", str(out)])
    assert rc == 0
    assert j_main(argv + ["--out", str(tmp_path / "jax_figs")]) == 0
    assert_same_outputs(out, tmp_path / "jax_figs")
    for name in ("heatmap_aggregate.png", "dev_history.png",
                 "campaign_summary.png", "replay_03_south.gif",
                 "routes/03_south/three_way_03_south.png",
                 "routes/03_south/README.md"):
        assert (out / name).stat().st_size > 0, name
    assert any((out / "route_groups").glob("heatmap_*.png"))
    assert not (out / "routes" / "09_se_ne").exists()
    assert "| ours |" in (out / "routes/03_south/README.md").read_text()


def test_analyze_overview_and_scene_view(tmp_path):
    """--overview draws the 15 routes over the scene's colliders; the scene
    view lays the colliders and a route's drops out as ``pack_scene``."""
    from nclt_slam_tpu_torch.cli.analyze import main, scene_view
    from nclt_slam_tpu_torch.rollout.scene_pack import pack_scene
    from nclt_slam_tpu_torch.scene import build_drops, default_scene, get_route

    drops = build_drops(get_route("03_south"))
    view = scene_view(default_scene(), drops)
    packed = pack_scene(default_scene(), drops, device="cpu")
    for name in view._fields:
        assert np.array_equal(getattr(view, name),
                              getattr(packed, name).numpy()), name
    assert view.drop_mask.sum() == len(drops.xy) and \
        (view.valid & view.drop_mask).any()
    from nclt_slam_tpu.cli.analyze import main as j_main

    assert main(["--overview", "--out", str(tmp_path)]) == 0
    assert (tmp_path / "routes_overview.png").stat().st_size > 5000
    assert j_main(["--overview", "--out", str(tmp_path / "jax")]) == 0
    assert_same_image(tmp_path / "routes_overview.png",
                      tmp_path / "jax" / "routes_overview.png")


def test_plot_trajectory_map_from_routes(tmp_path):
    from nclt_slam_tpu.scene import get_route as j_get_route
    from nclt_slam_tpu_torch.cli.analyze import scene_view
    from nclt_slam_tpu_torch.scene import default_scene, get_route

    names = ("01_road", "08_nw_sw")
    view = scene_view(default_scene())
    p = plot_trajectory_map(view, [get_route(n) for n in names],
                            tmp_path / "map.png")
    q = J.plot_trajectory_map(view, [j_get_route(n) for n in names],
                              tmp_path / "jax_map.png")
    assert p.exists() and p.stat().st_size > 5000
    assert_same_image(p, q)
