"""The port's command-line front ends (``nclt_slam_tpu_torch/cli``) against
the JAX package's, on the CPU.

``cli.campaign`` runs two real routes at full width with the depth-ray
grid cut by ``--scale 0.25`` (``tools/make_torch_fixture.py``'s
``cli_argv``); its traces.npz, metrics.json and markdown tables are held
against the JAX CLI's on the same arguments, recorded by that tool in
``tests/data/torch_cli_fixture.npz`` (a live JAX ours campaign compiles for
over a minute).  ``cli.teach`` -> ``cli.repeat --mode ours`` on one route go
through the files and are held against the JAX CLIs' files.

Tolerance: every discrete trace field (regime, anchor flags, waypoint
index, done, fired, VIO counts and flags), every integer and flag of the
metrics, the waypoint counts and the teach map's bytes are equal; poses,
waypoints and metric distances agree to ``POSE_ATOL`` m (float32 rounding
of the teach VIO's Gauss-Newton and the Procrustes alignment, ~1e-6 m;
the GT paths are bit-equal on the CPU); the printed tables, at 0.1 m /
0.01 m resolution, are JAX's text.  The split-phase and route-slice runs
are held to the one-call run bit for bit.
"""

import json
import pickle
import shutil
import sys
from contextlib import redirect_stdout
from io import StringIO
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the Procrustes flip-tie rule)
from make_torch_fixture import (  # noqa: E402
    CLI_OUT,
    CLI_REPEAT_FILES,
    CLI_TEACH_FILES,
    cli_argv,
    repeat_argv,
    teach_argv,
)

from nclt_slam_tpu_torch.cli import campaign as tcampaign  # noqa: E402
from nclt_slam_tpu_torch.eval.metrics import procrustes_flips_2d  # noqa: E402
from nclt_slam_tpu_torch.cli import repeat as trepeat  # noqa: E402
from nclt_slam_tpu_torch.cli import teach as tteach  # noqa: E402

# the test workers share the CPU: one intra-op thread each keeps their
# torch thread pools from oversubscribing it
torch.set_num_threads(1)

POSE_ATOL = 1e-4
FLOAT_KEYS = ("gt_xy", "nav_xy", "wps")
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def fx():
    with np.load(CLI_OUT) as z:
        return {k: z[k] for k in z.files}


def run_main(main, argv) -> str:
    buf = StringIO()
    with redirect_stdout(buf):
        assert main(argv + CPU) == 0
    return buf.getvalue()


def outputs(d: Path) -> dict:
    with np.load(d / "traces.npz") as z:
        traces = {k: z[k] for k in z.files}
    return {"traces": traces,
            "metrics": json.loads((d / "metrics.json").read_text())}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's campaign CLI: the GT campaign in one call; its teach phase
    alone, then the GT and the ours repeat phases and a GT route slice, each
    off a copy of that teach checkpoint."""
    root = tmp_path_factory.mktemp("cli")
    out = {"gt_stdout": run_main(tcampaign.main, cli_argv("gt", root / "gt"))}
    run_main(tcampaign.main, cli_argv("gt", root / "teach") +
             ["--phase", "teach"])
    for name, mode, extra in (("split", "gt", []), ("ours", "ours", []),
                              ("slice", "gt", ["--route-slice", "1:2",
                                               "--figures"])):
        (root / name).mkdir()
        shutil.copy(root / "teach" / "teach_state.ckpt", root / name)
        out[f"{name}_stdout"] = run_main(
            tcampaign.main, cli_argv(mode, root / name) +
            ["--phase", "repeat"] + extra)
    out.update({name: outputs(root / name)
                for name in ("gt", "split", "ours", "slice")})
    out["root"] = root
    return out


def table_block(stdout: str) -> str:
    start = stdout.index("# Per-route")
    end = stdout.index("(machine-readable")
    return stdout[start:end]


def assert_metrics_close(port: dict, ref: dict, where: str):
    assert port.keys() == ref.keys(), where
    for k, b in ref.items():
        a = port[k]
        if isinstance(b, dict):
            assert_metrics_close(a, b, f"{where}.{k}")
        elif isinstance(b, float) and not isinstance(b, bool):
            assert abs(a - b) <= POSE_ATOL, (where, k, a, b)
        else:
            assert a == b, (where, k, a, b)


@pytest.mark.parametrize("mode,run", [("gt", "gt"), ("ours", "ours")])
def test_campaign_matches_jax_cli(fx, runs, mode, run):
    """gt: ``--phase both``; ours: ``--phase repeat`` off the teach
    checkpoint (the teach phase is the same for every mode: the GT relay
    config, and the two presets' planners give the same waypoints)."""
    port = runs[run]["traces"]
    keys = [k[len(f"{mode}_trace_"):] for k in fx
            if k.startswith(f"{mode}_trace_")]
    assert sorted(port) == sorted(keys)
    for k in keys:
        a, b = port[k], fx[f"{mode}_trace_{k}"]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if k in FLOAT_KEYS:
            np.testing.assert_allclose(a, b, rtol=0, atol=POSE_ATOL,
                                       err_msg=k)
        else:
            assert np.array_equal(a, b), k
    assert_metrics_close(runs[run]["metrics"],
                         json.loads(str(fx[f"{mode}_metrics"])), mode)
    assert table_block(runs[f"{run}_stdout"]) == \
        table_block(str(fx[f"{mode}_stdout"]))


def test_campaign_exercised_the_path(runs):
    gt, ours = runs["gt"]["traces"], runs["ours"]["traces"]
    assert (gt["n_wps"] >= 2).all() and gt["wp_idx"][:, -1].min() >= 1
    path = np.hypot(*np.diff(gt["gt_xy"], axis=1).T).sum(0)
    assert (path > 0.5).all()
    assert (ours["regime"] >= 0).all() and (ours["vio_tracked"][:, -1] > 0).all()
    for d in ("gt", "teach"):
        assert (runs["root"] / d / "teach_state.ckpt").is_file()


def test_split_phase_equals_both(runs):
    """--phase teach, then --phase repeat in another call, gives the
    one-call run's files bit for bit."""
    a, b = runs["gt"], runs["split"]
    assert a["traces"].keys() == b["traces"].keys()
    for k, x in a["traces"].items():
        y = b["traces"][k]
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), k
    assert a["metrics"] == b["metrics"]
    root = runs["root"]
    assert (root / "gt" / "metrics.json").read_bytes() == \
        (root / "split" / "metrics.json").read_bytes()
    assert table_block(runs["gt_stdout"]) == table_block(runs["split_stdout"])


def test_route_slice_matches_rows(runs):
    """A --route-slice repeat gives its rows of the full run (and, with
    --figures, the route's figures)."""
    full, part = runs["gt"], runs["slice"]
    assert [str(n) for n in part["traces"]["names"]] == ["08_nw_sw"]
    for k, x in part["traces"].items():
        assert np.array_equal(x, full["traces"][k][1:2]), k
    assert part["metrics"]["per_route"]["08_nw_sw"] == \
        full["metrics"]["per_route"]["08_nw_sw"]
    assert part["metrics"]["aggregate"]["routes"] == 1
    figs = runs["root"] / "slice" / "figures"
    for name in ("campaign_summary.png", "run_08_nw_sw.png",
                 "drift_08_nw_sw.png"):
        assert (figs / name).stat().st_size > 5000, name


def csv_rows(data: bytes) -> np.ndarray:
    lines = data.decode().splitlines()[1:]
    return np.array([[float(v) for v in ln.split(",")] for ln in lines])


def aligned_track_agrees(port, ref, gt) -> bool:
    """The teach's aligned VIO track (vio_pose_dense.csv) is JAX's aligned
    again under one of the Procrustes flips that tie on JAX's track
    (``chip_smoke.procrustes_ties``): ``procrustes_align_2d`` keeps the best
    of four axis flips, and on a straight teach (this route's first 60
    ticks) the mirror images fit equally well (their mean errors tied to
    float64 rounding), so the flip it keeps follows the last bits of the
    VIO track.  A flip that does not tie is rejected.  The repeat reads the
    GT columns only."""
    tied, _ = chip_smoke.procrustes_ties(ref, gt)
    flipped, _ = procrustes_flips_2d(ref, gt)
    return any(np.allclose(port, flipped[k], rtol=0, atol=POSE_ATOL)
               for k in tied)


def test_teach_repeat_through_files(fx, tmp_path):
    """cli.teach writes the JAX CLI's teach files; cli.repeat reads them
    back from disk and writes the JAX CLI's repeat files."""
    td, rd = tmp_path / "teach", tmp_path / "repeat"
    run_main(tteach.main, teach_argv(td))
    for name in CLI_TEACH_FILES:
        port, ref = (td / name).read_bytes(), fx[f"teach/{name}"].tobytes()
        if name == "teach_map.yaml":   # it names the PGM by its path
            ref = ref.replace(str(fx["teach_dir"]).encode(), str(td).encode())
        if name in ("teach_map.pgm", "teach_map.yaml", "traj_gt.csv"):
            assert port == ref, name
        elif name == "vio_pose_dense.csv":
            a, b = csv_rows(port), csv_rows(ref)
            np.testing.assert_allclose(np.delete(a, [2, 3], 1),
                                       np.delete(b, [2, 3], 1), rtol=0,
                                       atol=POSE_ATOL)
            assert aligned_track_agrees(a[:, 2:4], b[:, 2:4], b[:, 9:11])
        else:
            a, b = pickle.loads(port), pickle.loads(ref)
            assert a.keys() == b.keys() and a["intrinsics"] == b["intrinsics"]
            assert len(a["landmarks"]) == len(b["landmarks"]) >= 1
            for la, lb in zip(a["landmarks"], b["landmarks"]):
                assert la.keys() == lb.keys()
                assert la["n_features"] == lb["n_features"]
                assert np.array_equal(la["descriptors"], lb["descriptors"])
                np.testing.assert_allclose(la["pose"], lb["pose"], rtol=0,
                                           atol=POSE_ATOL)
                for k in ("keypoints_2d", "keypoints_3d_cam"):
                    assert la[k].dtype == lb[k].dtype
                    np.testing.assert_allclose(la[k], lb[k], rtol=0,
                                               atol=POSE_ATOL)

    run_main(trepeat.main, repeat_argv(td, rd))
    for name in CLI_REPEAT_FILES:
        port, ref = (rd / name).read_bytes(), fx[f"repeat/{name}"].tobytes()
        if name == "metrics.json":
            assert_metrics_close(json.loads(port), json.loads(ref), name)
        else:
            np.testing.assert_allclose(csv_rows(port), csv_rows(ref), rtol=0,
                                       atol=POSE_ATOL, err_msg=name)


def test_figures_without_matplotlib_fail_before_the_run(monkeypatch,
                                                        capsys):
    """--figures without matplotlib is refused at argument parsing, before
    the campaign is built."""
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib"
                        else real(name, *a))
    monkeypatch.setattr(tcampaign, "build_campaign", None)  # never reached
    with pytest.raises(SystemExit) as e:
        tcampaign.main(["--routes", "01_road", "--out", "unused",
                        "--figures"] + CPU)
    assert e.value.code == 2
    assert "--figures needs matplotlib" in capsys.readouterr().err


@pytest.mark.parametrize("main,argv", [
    (tcampaign.main, ["--routes", "01_road", "--out", "unused"]),
    (tteach.main, ["--out", "unused"]),
    (trepeat.main, ["--teach-dir", "unused", "--out", "unused"]),
])
def test_clis_run_on_the_card_by_default(main, argv, monkeypatch):
    """No --device: the CUDA card, or an error before any work without one
    — never a silent CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv)
