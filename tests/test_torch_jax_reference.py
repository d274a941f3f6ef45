"""``tools/torch_jax_reference_probe.py``: JAX's repeat on the CPU off the
port's own teach.  Off a two-route, 60-tick CPU teach of the port, the
tool's rows at seeds (1, 2) (one batch of four, seed-major, in two pieces
through its resume checkpoint) against JAX's plain ``run_campaign_repeat``
of each route alone from ``init_repeat_carry(seed=s)`` (its row repeated
to fill a batch of the same size, so that the one compiled repeat serves
both): bit-equal; the tool's table in ``artifacts/calibration/
ours.json``'s schema; the anchor funnel over live attempts only; the
event counts on a synthetic trace.
"""

import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nclt_slam_tpu import config as jconfig
from nclt_slam_tpu.rollout import campaign as jcamp
from nclt_slam_tpu.rollout.repeat import init_repeat_carry as j_init_carry
from nclt_slam_tpu_torch import interop

from torch_calibrate_common import JAX_DIR, JAX_KEYS, SEEDS
import torch_calibrate  # noqa: E402
import torch_jax_reference_probe as probe  # noqa: E402

torch.set_num_threads(1)

ROUTES = ("08_nw_sw", "01_road")
TEACH_TICKS = 60   # two waypoints a route: not done within the repeat
TICKS = 20
CHUNK = 10


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The port's CPU teach through the calibration tool's own path, and
    the tool's JAX repeat off it at ``SEEDS`` (chunk by chunk through its
    checkpoint)."""
    tmp = tmp_path_factory.mktemp("jax_ref")
    shared, meta = torch_calibrate.teach_phase(
        list(ROUTES), TEACH_TICKS, "cpu", tmp / "teach.ckpt", CHUNK, None)
    loaded, _ = torch_calibrate.load_teach(tmp / "teach.ckpt", shared[0],
                                           "cpu")
    jdata, batch, carry, cfg = probe.jax_inputs(loaded, SEEDS)
    ckpt = tmp / "ref.ckpt"
    trace, rmeta = probe.run_repeat(batch, carry, cfg, TICKS, CHUNK, ckpt,
                                    {"mode": "ours"})
    return SimpleNamespace(shared=loaded, jdata=jdata, batch=batch,
                           carry=carry, cfg=cfg, trace=trace, meta=rmeta,
                           ckpt=ckpt)


def test_rows_are_each_route_alone(ref):
    """Row ``s * R + r`` is JAX's plain one-call repeat of route ``r`` alone
    from ``init_repeat_carry(seed=s)`` on the same teach artefacts, the
    route repeated over the batch's lanes: bit for bit, whatever the other
    rows hold and wherever the row lies."""
    data, teach, wps, n_wps = ref.shared
    R = len(ROUTES)
    B = R * len(SEEDS)
    assert [p[:2] for p in ref.meta["pieces"]] == [[0, CHUNK], [CHUNK, CHUNK]]
    assert not ref.trace.done[:, CHUNK - 1].all()

    def lanes(tree, r):
        return jax.tree_util.tree_map(
            lambda x: np.repeat(np.asarray(x)[r:r + 1], B, 0), tree)

    for i, s in enumerate(SEEDS):
        for r in range(R):
            routes = lanes(interop.to_numpy_tree(data.routes), r)
            w, n = lanes(wps.numpy(), r), lanes(n_wps.numpy(), r)
            one = jax.vmap(lambda rt, w, n, s=s: j_init_carry(
                rt, w, n, ref.cfg, seed=s))(routes, w, n)
            # the tool's carry is strongly typed (one compile for every
            # chunk); the same values
            carry = jax.tree_util.tree_map(lambda x: jnp.asarray(
                np.asarray(x)), one)
            alone = jcamp.CampaignData(
                None, lanes(interop.to_numpy_tree(data.scenes_repeat), r),
                routes, (ROUTES[r],) * B)
            rep = jcamp.run_campaign_repeat(
                alone, lanes(teach.teach_grid.numpy(), r), w, n, ref.cfg,
                TICKS, stores=lanes(interop.to_numpy_tree(teach.store), r),
                chunk=CHUNK, carry=carry)
            got = np.asarray(rep.trace.gt_xy)
            assert all(np.array_equal(got[0], got[k]) for k in range(B))
            row = i * R + r
            for f in rep.trace._fields:
                assert np.array_equal(getattr(ref.trace, f)[row],
                                      np.asarray(getattr(rep.trace, f))[0]), \
                    (f, s, r)
    # the two seeds' rows are two draws
    assert not all(np.array_equal(x[:R], x[R:]) for x in ref.trace)


def test_resume_returns_the_checkpointed_run(ref):
    """A second run with the same checkpoint finds the repeat finished and
    returns its trace without stepping; another mode is refused."""
    trace, meta = probe.run_repeat(ref.batch, ref.carry, ref.cfg, TICKS,
                                   CHUNK, ref.ckpt, {"mode": "ours"})
    assert meta["calls"] == 2 and meta["pieces"] == ref.meta["pieces"]
    for a, b in zip(trace, ref.trace):
        assert np.array_equal(a, b)
    with pytest.raises(SystemExit, match="holds a repeat"):
        probe.run_repeat(ref.batch, ref.carry, ref.cfg, TICKS, CHUNK,
                         ref.ckpt, {"mode": "rgbd"})


def test_table_has_the_jax_schema(ref):
    want = json.loads((JAX_DIR / "ours.json").read_text())
    _, _, wps, n_wps = ref.shared
    drift = {n: (0.5, 1.0) for n in ROUTES}
    tables = probe.seed_tables(ref.jdata, ref.trace, wps.numpy(),
                               n_wps.numpy(), ref.cfg, SEEDS, TICKS, CHUNK,
                               drift)
    assert list(tables) == list(SEEDS)
    m0 = next(iter(want["per_route"].values()))
    a0 = next(iter(want["anchor"].values()))
    for s, (t, n) in tables.items():
        assert n == TICKS
        t = json.loads(json.dumps(t, default=float))
        assert set(JAX_KEYS) <= set(t) and t["mode"] == "ours"
        assert list(t["per_route"]) == list(ROUTES)
        for m in t["per_route"].values():
            assert set(m) == set(m0)
        assert set(t["agg"]) == set(want["agg"])
        assert t["teach_drift"] == {n: [0.5, 1.0] for n in ROUTES}
        for a in t["anchor"].values():
            assert set(a) == set(a0)
        assert list(t["events"]) == list(ROUTES)


def test_teach_drift_is_the_ports():
    """The tool's teach drift (JAX's ``procrustes_drift_2d``, as
    ``tools/calibrate.py``) is the port's tool's on one trace."""
    rng = np.random.default_rng(3)
    T = 400
    gt = np.cumsum(rng.normal(0, 0.1, (2, T, 2)), 1).astype(np.float32)
    vio = (gt + rng.normal(0, 0.05, gt.shape)).astype(np.float32)
    done = np.zeros((2, T), bool)
    done[1, 300:] = True
    tr = SimpleNamespace(vio_xy=vio, gt_xy=gt, done=done)
    got = probe.teach_drift(("a", "b"), tr)
    want = torch_calibrate.teach_drift(("a", "b"), tr)
    for k in ("a", "b"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0)


def synthetic_trace():
    """Two routes, 12 ticks: route 0 done from tick 9, route 1 live."""
    T = 12
    z = np.zeros((2, T), np.int32)
    done = np.zeros((2, T), bool)
    done[0, 9:] = True
    reason = np.full((2, T), -1, np.int32)
    reason[0, [0, 2, 4, 10]] = [0, 1, 3, 0]     # tick 10: parked
    reason[1, [1, 3]] = [4, 0]
    ok = reason == 0
    tracked = np.full((2, T), 40, np.int32)
    tracked[0, 2:6] = 10                         # 4 starved frames
    tracked[0, 10] = 5                           # parked: not counted
    yaw = np.zeros((2, T), np.float32)
    yaw[1, 5:] = 0.1 * np.arange(1, T - 4)       # 1 rad/s from tick 5
    flags = np.zeros((2, T), np.int32)
    flags[0, 3] = 1 << 3                         # lost
    flags[1, [4, 7]] = (1 << 5) | (1 << 4)       # snap + reloc
    flags[0, 11] = 1 << 5                        # parked: not counted
    gt = np.zeros((2, T, 2), np.float32)
    nav = np.zeros((2, T, 2), np.float32)
    nav[1, 6:, 0] = 0.8                          # one jump, at tick 6
    nav[0, 10:, 1] = 2.0                         # parked jump
    shift = np.where(ok, 1.5, 0.0).astype(np.float32)
    return SimpleNamespace(
        done=done, anchor_reason=reason, anchor_ok=ok, anchor_shift=shift,
        anchor_inliers=np.where(ok, 30, 0).astype(np.int32),
        vio_tracked=tracked, vio_flags=flags, gt_yaw=yaw, gt_xy=gt,
        nav_xy=nav, cmd_v=z)


def test_anchor_funnel_counts_live_attempts_only():
    a = torch_calibrate.anchor_outcomes(("r0", "r1"), synthetic_trace())
    assert a["r0"]["attempts"] == 3
    assert a["r0"]["frac"] == {"published": 1 / 3, "no_candidates": 1 / 3,
                               "no_pnp_accept": 1 / 3}
    assert a["r1"]["attempts"] == 2
    assert a["r1"]["frac"] == {"consistency_fail": 0.5, "published": 0.5}
    assert a["r0"]["shift_median"] == pytest.approx(1.5)


def test_route_events_on_a_synthetic_trace():
    vio = SimpleNamespace(snap_stress_match_n=0, snap_stress_rot=0.62,
                          snap_stress_min=5, snap_starve_match_n=14,
                          snap_starve_min=3)
    ev = torch_calibrate.route_events(("r0", "r1"), synthetic_trace(), vio)
    assert ev["r0"] == {"live_ticks": 9, "stressed": 0, "stress_armed": 0,
                        "starved": 4, "starve_armed": 2, "lost": 1,
                        "reloc": 0, "snaps": 0, "jumps": 0, "published": 1}
    # yaw turns at 1 rad/s from tick 5 (ticks 5..11 stressed, armed from
    # the fifth of them, tick 9)
    assert ev["r1"] == {"live_ticks": 12, "stressed": 7, "stress_armed": 3,
                        "starved": 0, "starve_armed": 0, "lost": 0,
                        "reloc": 2, "snaps": 2, "jumps": 1, "published": 1}


def test_route_events_use_the_configs_thresholds():
    cfg = jconfig.ours().vio
    tr = synthetic_trace()
    ev = torch_calibrate.route_events(("r0", "r1"), tr, cfg)
    assert cfg.snap_starve_min == 30 and ev["r0"]["starve_armed"] == 0
    assert ev["r0"]["starved"] == 4


def test_jax_runs_on_the_cpu():
    assert probe.jax_cpu().devices()[0].platform == "cpu"
    line = probe.cpu_line()
    assert line["cores"] >= 1 and set(line) == {"model", "cores"}


def test_tool_refuses_a_teach_without_its_routes(tmp_path, ref):
    """A teach checkpoint that lacks a route asked for is refused."""
    with pytest.raises((SystemExit, ValueError, KeyError)):
        probe.main(["--teach-ckpt", str(Path(ref.ckpt).parent / "teach.ckpt"),
                    "--routes", "03_south", "--ticks", "10"])
