"""The port's dataset benchmark CLI (``nclt_slam_tpu_torch/cli/benchmark.py``)
against the JAX package's ``cli/benchmark.py``.

- The session worlds (``_loop_route``, ``_facade_world``,
  ``_condition_windows``, drawn in ``run_dataset``'s order) are equal bit
  for bit, but for the facades' base heights, which come from
  ``terrain_height`` (XLA's sin/cos against torch's: within 1e-6 m).
- ``_run_session`` replays ``tests/data/torch_benchmark_fixture.npz`` (JAX's
  ``_run_session`` of the RobotCar dusk and 4Seasons autumn sessions, made
  by ``python tools/make_torch_fixture.py --mode benchmark``) over its
  first ``REPLAY_TICKS`` ticks with the ours fixture replay's tolerances:
  the VIO's lost flags and match counts equal, the VIO track within 1e-3 m,
  the ground truth within 1e-2 m (yaw 1e-3 rad), the tick's mean body rate
  within 1e-3 rad/s and mean specific force within 1e-2 m/s^2 (the IMU
  differentiates the 200 Hz pose twice, so a position ulp is ~1e-2 m/s^2
  there).  On the CPU the port stays within 1e-5 of all of them.
- ``run_dataset`` at the fixture's small tick budget writes the JAX run's
  file set, with the same JSON keys, the same reference row and the same
  markdown table layout (``wall_s`` and the numbers excepted).
"""

import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from make_torch_fixture import BENCH_OUT, bench_sessions  # noqa: E402

from nclt_slam_tpu.cli import benchmark as jb  # noqa: E402
from nclt_slam_tpu_torch.cli import benchmark as tb  # noqa: E402

torch.set_num_threads(1)

REPLAY_TICKS = 50
GT_ATOL_M = 1e-2
YAW_ATOL = 1e-3
VIO_ATOL_M = 1e-3
GYRO_ATOL = 1e-3
ACCEL_ATOL = 1e-2


@pytest.fixture(scope="module")
def fx():
    return np.load(BENCH_OUT)


@pytest.mark.parametrize("dataset", ["robotcar", "4seasons"])
def test_session_worlds_match_jax(dataset):
    route, world, sessions, cfg = tb.dataset_sessions(dataset, 300)
    jroute, jworld, jsessions, _ = bench_sessions(jb, 300)[dataset]
    jcks = [ck for ck, _ in jsessions.values()]
    assert route.dtype == np.float32 and np.array_equal(route, jroute)
    for i in (0, 1, 3):                         # xy, radius, height
        assert world[i].dtype == jworld[i].dtype
        assert np.array_equal(world[i], jworld[i]), i
    np.testing.assert_allclose(world[2], np.asarray(jworld[2]), rtol=0,
                               atol=1e-6)
    cks = [ck for ck, _ in sessions.values()]
    for ck, jck in zip(cks, jcks):
        assert ck.dtype == np.float32 and np.array_equal(ck, jck)
    assert (cks[1] < 1).any()
    assert [imu for _, imu in sessions.values()] == [dataset == "4seasons"] * 2
    from nclt_slam_tpu_torch import config as tcfg
    assert cfg == (tcfg.rgbd_no_imu() if dataset == "robotcar"
                   else tcfg.ours())
    # the helpers alone, on a fresh generator
    rng_j, rng_t = np.random.default_rng(5), np.random.default_rng(5)
    assert np.array_equal(tb._condition_windows(1000, rng_t, 3),
                          jb._condition_windows(1000, rng_j, 3))
    assert np.array_equal(tb._loop_route(300.0, rng_t, spacing=0.5),
                          jb._loop_route(300.0, rng_j, spacing=0.5))


@pytest.mark.parametrize("dataset,session", [("robotcar", "dusk"),
                                             ("4seasons", "autumn")])
def test_run_session_replays_jax_fixture(fx, dataset, session):
    ticks = int(fx["ticks"])
    route, world, sessions, cfg = tb.dataset_sessions(dataset, ticks,
                                                      int(fx["seed"]))
    ck, use_imu = sessions[session]
    pre = f"{dataset}/{session}/"
    assert np.array_equal(ck, fx[pre + "cond_keep"])
    if dataset == "robotcar":
        assert (ck[:REPLAY_TICKS] < 1).sum() >= 10     # a drought window
    progress = []
    tr = tb._run_session(route, world, ck, use_imu, cfg, REPLAY_TICKS, "cpu",
                         chunk=20, seed=int(fx["seed"]),
                         progress=lambda t, n: progress.append((t, n)))
    assert progress == [(20, REPLAY_TICKS), (40, REPLAY_TICKS),
                        (REPLAY_TICKS, REPLAY_TICKS)]
    n = REPLAY_TICKS

    def want(field):
        return fx[pre + field][:n]

    for field in tb._SessTrace._fields:
        got = getattr(tr, field)
        assert got.shape == want(field).shape, field
        assert got.dtype == want(field).dtype, field
    assert np.array_equal(tr.lost, want("lost"))
    assert np.array_equal(tr.n_tracked, want("n_tracked"))
    assert want("n_tracked").max() > 100
    np.testing.assert_allclose(tr.gt_xy, want("gt_xy"), rtol=0,
                               atol=GT_ATOL_M)
    np.testing.assert_allclose(tr.gt_yaw, want("gt_yaw"), rtol=0,
                               atol=YAW_ATOL)
    np.testing.assert_allclose(tr.vio_xy, want("vio_xy"), rtol=0,
                               atol=VIO_ATOL_M)
    np.testing.assert_allclose(tr.gyro, want("gyro"), rtol=0,
                               atol=GYRO_ATOL)
    np.testing.assert_allclose(tr.accel, want("accel"), rtol=0,
                               atol=ACCEL_ATOL)
    assert np.linalg.norm(tr.gt_xy[-1] - tr.gt_xy[0]) > 2.0


def keys(tree):
    if isinstance(tree, dict):
        return {k: keys(v) for k, v in tree.items()}
    return type(tree).__name__


def md_layout(text: str):
    """The table's lines with every number replaced by N."""
    return [re.sub(r"-?\d+(\.\d+)?(e-?\d+)?|nan|NaN", "N", ln)
            for ln in text.splitlines()]


@pytest.mark.parametrize("dataset", ["robotcar", "4seasons"])
def test_run_dataset_writes_the_jax_file_set(fx, tmp_path, capsys, dataset):
    ticks = int(fx["small_ticks"])
    payload = tb.run_dataset(dataset, tmp_path, ticks, "cpu", export=True,
                             seed=int(fx["seed"]))
    text = capsys.readouterr().out
    assert f"wrote {tmp_path}/{dataset}_bench.json" in text
    files = sorted(str(p.relative_to(tmp_path)) for p in tmp_path.rglob("*")
                   if p.is_file())
    jfiles = [str(f) for f in fx["run/files"] if str(f).startswith(dataset)]
    assert files == jfiles
    first = dict(zip(fx["run/files"], fx["run/first_lines"]))
    n_lines = dict(zip(fx["run/files"], fx["run/n_lines"]))
    for f in files:
        lines = (tmp_path / f).read_text().splitlines()
        assert len(lines) == n_lines[f], f
        if first[f].startswith("#"):         # a header line
            assert lines[0] == first[f], f
        else:
            assert len(lines[0].split()) == len(str(first[f]).split()), f
    got = json.loads((tmp_path / f"{dataset}_bench.json").read_text())
    want = json.loads(str(fx[f"run/{dataset}_bench.json"]))
    assert keys(got) == keys(want)
    assert got == json.loads(json.dumps(payload))
    assert got["reference"] == want["reference"]
    assert got["n_ticks"] == want["n_ticks"] == ticks
    for name, row in got["rows"].items():
        assert row["frames"] == want["rows"][name]["frames"]
        assert row["euroc_dir"] == str(tmp_path / f"{dataset}_{name}/mav0")
    md = (tmp_path / f"{dataset}_bench.md").read_text()
    assert md_layout(md) == md_layout(str(fx[f"run/{dataset}_bench.md"]))
    assert md.splitlines()[-3] == str(
        fx[f"run/{dataset}_bench.md"]).splitlines()[-3]   # the reference row


def test_reference_rows_and_cli_device():
    """The reference rows are the JAX package's (4Seasons' 99.99 % copied
    with its note), and the CLI takes the card unless told otherwise."""
    assert tb.REFERENCE_ROWS == jb.REFERENCE_ROWS
    if torch.cuda.is_available():
        from nclt_slam_tpu_torch.rollout.campaign import campaign_device
        assert campaign_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.main(["--dataset", "robotcar", "--ticks", "2", "--out", "unused"])
