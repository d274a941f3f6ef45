"""The port's calibration front end in pieces and its campaign parity check.

- ``tools/torch_calibrate.py``'s split path: the teach written to its
  checkpoint (``teach_phase``), then ``main`` run once per repeat chunk
  (``--budget-s 0`` pauses after every chunk into ``--repeat-ckpt``, the
  next run loads the teach and continues the repeat): the table it writes
  (the JAX tool's keys and the executed ticks) equals the one-call
  ``run``'s off the same teach, exactly, for ours and for stock (whose
  waypoint projection runs again at every chunk).  Two routes at full
  width on the CPU; the teach passes the teach drift's 200-tick settling
  window.
- ``tools/torch_campaign_parity.py``: every band holds on a JAX table
  against itself; three reach flips miss B1 alone, coverage moved by 7
  points misses B3 alone; a missed band is "chaos" only where its mode's
  probes held and ran every stage that decides it, "fault" where one
  found a stage that differs, else "unresolved"; the encoder table is
  reported, never banded.
- The committed card tables (``artifacts/calibration_torch``) have the JAX
  tool's schema and 15 routes.
- The repeat's seed axis (``--seeds``): the stock repeat at the two routes
  x seeds (1, 2) as one batch of four rows for 20 ticks; seed 1's rows
  bit-equal beside seed 2 or seed 3, each block against the untiled run
  started from ``init_repeat_carry(seed=s)`` (discrete sequences equal,
  floats within the CPU's vector-tail rounding); the port's seed-2 carry
  (key, IMU state) equal to JAX's; seed 2's rows against JAX's ``run_campaign_repeat``
  from JAX's seed-2 carry within the fixture replays' tolerances
  (``chip_smoke.FIX_*``); the tool's per-seed tables and stop tick.
- The spread test (``torch_campaign_parity.SPREAD``) on hand-made seed
  tables: the 99 % prediction interval at K = 8, a value just inside and
  just outside it, s = 0, two against three unseen routes, a missed band's
  verdict from chaos through outside to fault or unresolved; ``BANDS``
  and ``SPREAD`` still the values fixed before the card runs.
"""

import copy
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402
import torch_batch_probe  # noqa: E402
import torch_calibrate  # noqa: E402
import torch_campaign_parity as parity  # noqa: E402

from nclt_slam_tpu.baselines import configs as jbase  # noqa: E402
from nclt_slam_tpu.rollout import campaign as jcamp  # noqa: E402
from nclt_slam_tpu.rollout.repeat import init_repeat_carry as j_init_carry  # noqa: E402
from nclt_slam_tpu_torch import interop  # noqa: E402
from nclt_slam_tpu_torch.rollout import campaign as tcamp  # noqa: E402
from nclt_slam_tpu_torch.rollout.repeat import RepeatResult, init_repeat_carry  # noqa: E402

torch.set_num_threads(1)

ROUTES = ("08_nw_sw", "01_road")
TEACH_TICKS = 210
REPEAT_TICKS = 20
CHUNK = 10
JAX_DIR = REPO / "artifacts" / "calibration"
CARD_DIR = REPO / "artifacts" / "calibration_torch"
JAX_KEYS = ("mode", "per_route", "agg", "teach_drift", "anchor")
SEEDS = (1, 2)
SEED_DIR = CARD_DIR / parity.SEED_DIR
CPU_BATCH_ATOL = 1e-5   # seed blocks against untiled runs, CPU only


@pytest.fixture(scope="module")
def taught(tmp_path_factory):
    """One teach through the tool's own path, written to its checkpoint."""
    ckpt = tmp_path_factory.mktemp("calibrate") / "teach.ckpt"
    shared, meta = torch_calibrate.teach_phase(
        list(ROUTES), TEACH_TICKS, "cpu", ckpt, CHUNK, None)
    assert ckpt.is_file()
    return shared, meta, ckpt


ONE_CALL = {}


def one_call(shared, mode):
    """``torch_calibrate.run``'s repeat of ``mode`` off the module's teach
    (run once)."""
    if mode not in ONE_CALL:
        ONE_CALL[mode] = torch_calibrate.run(
            None, mode, TEACH_TICKS, REPEAT_TICKS, "cpu", shared=shared,
            chunk=CHUNK)
    return ONE_CALL[mode]


@pytest.mark.parametrize("mode", ["ours", "stock"])
def test_split_path_writes_the_one_call_table(taught, mode, tmp_path,
                                              monkeypatch):
    shared, meta, ckpt = taught
    (names, per_route, agg, drift, anchor), _, rep = one_call(shared, mode)
    one = json.loads(json.dumps(torch_calibrate.table(
        names, per_route, agg, drift, anchor, mode), default=float))

    # the split runs rebuild the campaign from the seed; hand them the
    # module's build (the same data) to save its seconds
    monkeypatch.setattr(torch_calibrate, "build",
                        lambda names, device: shared[0])
    argv = ["--routes", ",".join(ROUTES), "--mode", mode,
            "--ticks", str(REPEAT_TICKS), "--teach-ticks", str(TEACH_TICKS),
            "--chunk", str(CHUNK), "--device", "cpu",
            "--teach-ckpt", str(ckpt),
            "--repeat-ckpt", str(tmp_path / "MODE.ckpt"), "--budget-s", "0",
            "--json", str(tmp_path / "MODE.json")]
    assert torch_calibrate.main(argv) == torch_calibrate.PAUSED
    assert (tmp_path / f"{mode}.ckpt").is_file()
    assert not (tmp_path / f"{mode}.json").exists()
    assert torch_calibrate.main(argv) == 0
    assert not (tmp_path / f"{mode}.ckpt").exists()
    got = json.loads((tmp_path / f"{mode}.json").read_text())
    for key in JAX_KEYS:
        assert got[key] == one[key], key
    assert got["ticks_executed"] == {"teach": TEACH_TICKS,
                                     "repeat": REPEAT_TICKS}
    assert got["repeat_calls"] == 2
    assert got["card"] == {"teach": None, "repeat": [None]}
    assert set(got["wall_s"]) == {"build", "teach", "repeat", "metrics"}
    assert got["wall_s"]["teach"] == meta["teach_s"]


def test_teach_checkpoint_refuses_another_teach(taught):
    _, _, ckpt = taught
    with pytest.raises(SystemExit, match="holds a teach"):
        torch_calibrate.teach_phase(list(ROUTES), TEACH_TICKS + 1, "cpu",
                                    ckpt, CHUNK, None)


def jax_tables(tmp_path, edit=None):
    """The JAX tables copied to ``tmp_path`` (one of them edited)."""
    for m in parity.BANDED:
        t = json.loads((JAX_DIR / f"{m}.json").read_text())
        if edit is not None:
            t = edit(m, t)
        (tmp_path / f"{m}.json").write_text(json.dumps(t))
    return tmp_path


def test_parity_holds_every_band_on_jax_against_itself(tmp_path):
    res = parity.check(jax_tables(tmp_path), JAX_DIR)
    assert res["held"] and res["missed_bands"] == []
    assert {r["band"] for r in res["bands"]} == set(parity.BANDS)
    assert parity.main(["--port-dir", str(tmp_path), "--ref-dir",
                        str(JAX_DIR)]) == 0
    written = json.loads((tmp_path / "parity.json").read_text())
    assert written["held"] and len(written["bands"]) == len(res["bands"])


def flip_reach(mode, t, n=3):
    """Three routes of ours that reached their final WP, now short of it."""
    if mode != "ours":
        return t
    t = copy.deepcopy(t)
    hit = [k for k, m in t["per_route"].items() if m["reached_final"]][:n]
    for k in hit:
        t["per_route"][k]["reached_final"] = False
    t["agg"]["reach"] -= len(hit)
    return t


def move_coverage(mode, t, points=7.0):
    if mode != "rgbd":
        return t
    t = copy.deepcopy(t)
    t["agg"]["avg_coverage_pct"] += points
    return t


@pytest.mark.parametrize("edit,band,mode", [(flip_reach, "B1", "ours"),
                                            (move_coverage, "B3", "rgbd")],
                         ids=["three_reach_flips", "coverage_plus_7"])
def test_parity_miss_touches_only_its_band(tmp_path, edit, band, mode):
    res = parity.check(jax_tables(tmp_path, edit), JAX_DIR)
    assert not res["held"] and res["missed_bands"] == [band]
    missed = [r for r in res["bands"] if not r["held"]]
    assert len(missed) == 1 and missed[0]["mode"] == mode
    # three flips leave 12 of 15 routes agreeing: B2's floor, held
    b2 = [r for r in res["bands"] if r["band"] == "B2" and r["mode"] == mode]
    assert all(r["held"] for r in b2)


def probe(mode, verdict, checked):
    """A divergence probe's summary of one route of ``mode``."""
    return {"route": "04_nw_se", "phase": "repeat", "mode": mode,
            "verdict": verdict,
            "repeat": {"checks": [], "stages_checked": list(checked)}}


@pytest.mark.parametrize("probes,want,unchecked", [
    ([probe("rgbd", "chaos", parity.NAV)], "chaos", []),
    ([probe("rgbd", "chaos", ("vio_frame", "fusion_tick"))], "unresolved",
     list(parity.NAV)),
    ([probe("rgbd", "chaos", parity.NAV[1:])], "unresolved",
     list(parity.NAV[:1])),
    ([probe("rgbd", "fault", parity.NAV)], "fault", []),
    ([probe("stock", "chaos", parity.NAV)], "unresolved", None),
], ids=["chaos", "deciding_stages_unchecked", "costmap_unchecked", "fault",
        "no_probe_of_the_mode"])
def test_missed_band_verdict_rests_on_its_deciding_stages(tmp_path, probes,
                                                          want, unchecked):
    port = jax_tables(tmp_path, move_coverage)
    (port / parity.EVIDENCE).write_text(json.dumps({"probes": probes}))
    res = parity.check(port, JAX_DIR)
    (missed,) = [r for r in res["bands"] if not r["held"]]
    assert (missed["band"], missed["mode"]) == ("B3", "rgbd")
    assert missed["verdict"] == want
    if unchecked is None:
        assert missed["evidence"] == []
    else:
        assert missed["evidence"][0]["deciding_unchecked"] == unchecked


def test_encoder_is_reported_not_banded(tmp_path):
    enc = json.loads((JAX_DIR / "encoder.json").read_text())
    enc["agg"]["reach"] = 0
    enc["agg"]["avg_coverage_pct"] = 0.0
    port = jax_tables(tmp_path)
    (port / "encoder.json").write_text(json.dumps(enc))
    res = parity.check(port, JAX_DIR)
    assert res["held"]
    assert all(r["mode"] != "encoder" for r in res["bands"])
    assert res["unbanded"]["encoder"]["agg"]["reach"] == 0


@pytest.mark.parametrize("mode", ["ours", "rgbd", "stock", "encoder"])
def test_committed_card_tables_have_the_jax_schema(mode):
    got = json.loads((CARD_DIR / f"{mode}.json").read_text())
    want = json.loads((JAX_DIR / f"{mode}.json").read_text())
    assert got["mode"] == mode
    assert set(JAX_KEYS) <= set(got)
    assert list(got["per_route"]) == list(want["per_route"])
    assert len(got["per_route"]) == 15
    for name, m in got["per_route"].items():
        assert set(m) == set(want["per_route"][name]), name
    assert set(got["agg"]) == set(want["agg"])
    assert list(got["teach_drift"]) == list(want["teach_drift"])
    # one teach for every mode (it stops once every route is done)
    ours = json.loads((CARD_DIR / "ours.json").read_text())
    assert got["teach_drift"] == ours["teach_drift"]
    assert got["ticks_executed"]["teach"] == \
        ours["ticks_executed"]["teach"] <= 12000
    assert 0 < got["ticks_executed"]["repeat"] <= 12000
    assert "H100" in got["card"]["teach"]
    assert all("H100" in c for c in got["card"]["repeat"])


def test_committed_parity_report_is_the_checkers():
    """``parity.json`` beside the tables is what the checker computes from
    them now (bands, verdicts, the attached probe evidence and the spread
    section over the seed tables)."""
    want = json.loads((CARD_DIR / "parity.json").read_text())
    got = json.loads(json.dumps(parity.check(CARD_DIR, JAX_DIR)))
    assert got == want
    assert set(want["spread"]["modes"]) >= {"stock", "rgbd"}


def test_committed_seed_tables_have_the_schema():
    """Each committed seed file holds K >= 2 tables in the JAX tool's
    schema, off the committed tables' teach, each with its own executed
    repeat ticks, beside the batch's ticks, timings and card."""
    files = sorted(SEED_DIR.glob("*.json"))
    assert {f.stem for f in files} >= {"stock", "rgbd"}
    teach = json.loads((CARD_DIR / "stock.json").read_text())["teach_drift"]
    for f in files:
        got = json.loads(f.read_text())
        assert got["mode"] == f.stem and len(got["seeds"]) >= 2
        assert list(got["tables"]) == [str(s) for s in got["seeds"]]
        assert got["rows"] == 15 * len(got["seeds"])
        for t in got["tables"].values():
            assert set(JAX_KEYS) <= set(t) and t["mode"] == f.stem
            assert len(t["per_route"]) == 15
            assert t["teach_drift"] == teach
            assert 0 < t["repeat_ticks"] <= got["ticks_executed"]["repeat"]
        assert max(t["repeat_ticks"] for t in got["tables"].values()) == \
            got["ticks_executed"]["repeat"]
        assert got["peak_memory_bytes"] > 0
        assert "H100" in got["card"]["teach"]
        assert all("H100" in c for c in got["card"]["repeat"])


def test_committed_spread_verdicts_cover_every_missed_band():
    """Every missed band of a mode with a seed file carries a spread
    verdict of the fixed test, and the witness of its seed-1 table."""
    got = json.loads((CARD_DIR / "parity.json").read_text())
    sp = got["spread"]
    assert sp["test"] == parity.SPREAD
    for r in got["bands"]:
        if not r["held"] and r["mode"] in sp["modes"]:
            assert r["spread"] in ("chaos", "outside", "fault",
                                   "unresolved"), r
    assert set(sp["witness"]) == set(sp["modes"])


# --- the seed axis --------------------------------------------------------

def untiled(shared, mode, seed):
    """The mode's untiled two-route repeat started from
    ``init_repeat_carry(seed=seed)`` (at seed 1 the tool's one-call run)."""
    if seed == 1:
        return one_call(shared, mode)[2]
    data, teach, wps, n_wps = shared
    cfg = torch_calibrate.mode_config(mode)
    run_wps, run_n = tcamp.apply_stock_projection(teach.teach_grid, wps,
                                                  n_wps, cfg)
    return tcamp.run_campaign_repeat(
        data, teach.teach_grid, wps, n_wps, cfg, REPEAT_TICKS,
        stores=teach.store, chunk=CHUNK,
        carry=init_repeat_carry(data.routes, run_wps, run_n, cfg,
                                seed=seed))


@pytest.fixture(scope="module")
def seed_runs(taught):
    """The stock repeat tiled at seeds (1, 2) and at (1, 3), and the untiled
    runs at seeds 1 and 2."""
    shared = taught[0]
    tiled = {seeds: torch_calibrate.repeat_phase(
        shared, "stock", REPEAT_TICKS, CHUNK, None, None, 0.0, None,
        seeds=seeds) for seeds in (SEEDS, (1, 3))}
    return tiled, {s: untiled(shared, "stock", s) for s in SEEDS}


def rows(trace, i):
    R = len(ROUTES)
    return type(trace)(*(np.asarray(x)[i * R:(i + 1) * R] for x in trace))


def test_seed_block_depends_on_its_seed_alone(seed_runs):
    """Seed 1's rows bit-equal whichever seed fills the other block (one
    batch shape), seed 2's rows not seed 1's."""
    tiled, _ = seed_runs
    (a, meta), (b, _) = tiled[SEEDS], tiled[(1, 3)]
    assert meta["seeds"] == list(SEEDS)
    assert a.trace.done.shape == (len(ROUTES) * 2, REPEAT_TICKS)
    for f in a.trace._fields:
        assert chip_smoke.same_bits(getattr(rows(a.trace, 0), f),
                                    getattr(rows(b.trace, 0), f)), f
    assert not chip_smoke.same_bits(rows(a.trace, 0).vio_xy,
                                    rows(a.trace, 1).vio_xy)


def test_seed_blocks_are_the_untiled_runs(seed_runs):
    """Each block against the untiled run from ``init_repeat_carry(seed=s)``:
    every discrete sequence equal, every float within ``CPU_BATCH_ATOL``.
    Not bit for bit on the CPU: ATen's vectorized ``atan2`` rounds the
    scalar tail of a tensor another way than its vector body (4.7e-10 at
    tick 0 in ``terrain_pitch_roll``), and a tensor of more rows puts
    other elements in the tail; on the card every element takes one path,
    and ``chip_smoke.py`` 11i holds the blocks bit-equal to the untiled
    run."""
    tiled, one = seed_runs
    trace = tiled[SEEDS][0].trace
    for i, s in enumerate(SEEDS):
        got, want = rows(trace, i), one[s].trace
        for f in got._fields:
            g, w = getattr(got, f), getattr(want, f)
            if g.dtype.kind == "f":
                np.testing.assert_allclose(g, w, rtol=0,
                                           atol=CPU_BATCH_ATOL,
                                           err_msg=f"seed {s} {f}")
            else:
                assert np.array_equal(g, w), (s, f)


def test_seed_tables_split_the_batch(taught, seed_runs):
    """``seed_tables``: each seed's table is the table of its own rows, over
    its own stop tick; seed 1's table is the same beside seed 2 or 3."""
    shared = taught[0]
    tiled, _ = seed_runs
    drift = torch_calibrate.teach_drift(shared[0].names, shared[1].trace)
    tables = {seeds: torch_calibrate.seed_tables(
        shared, tiled[seeds][0], "stock", seeds, REPEAT_TICKS, CHUNK, drift)
        for seeds in tiled}
    assert list(tables[SEEDS]) == list(SEEDS)
    dump = lambda t: json.dumps(t, default=float)  # noqa: E731
    assert dump(tables[SEEDS][1]) == dump(tables[(1, 3)][1])
    for i, s in enumerate(SEEDS):
        trace = rows(tiled[SEEDS][0].trace, i)
        per_route, agg = tcamp.campaign_metrics(
            shared[0], RepeatResult(trace=trace, final=None), shared[2],
            shared[3], torch_calibrate.mode_config("stock"))
        want = torch_calibrate.table(
            shared[0].names, per_route, agg, drift,
            torch_calibrate.anchor_outcomes(shared[0].names, trace), "stock")
        assert dump(tables[SEEDS][s]) == dump((want, REPEAT_TICKS))


def test_batch_probe_finds_the_cpus_vector_tails(taught):
    """``tools/torch_batch_probe.py`` on the CPU: the one call that gives
    the first rows otherwise at twice the rows, in the first stock tick,
    is ATen's vectorized ``atan2``."""
    calls = torch_batch_probe.batch_dependent_calls(taught[0], "stock",
                                                    SEEDS, 0, 1)
    assert calls and {c["call"] for c in calls} == {"atan2"}
    assert all(c["site"].startswith("nclt_slam_tpu_torch/") for c in calls)


def test_batch_probe_first_differences(seed_runs):
    """Seed 1's rows against themselves: no difference; against seed 2's
    rows: the first tick of each field that differs."""
    tiled, one = seed_runs
    R = len(ROUTES)
    assert torch_batch_probe.first_differences(one[1].trace,
                                               one[1].trace, R) == {}
    got = torch_batch_probe.first_differences(
        rows(tiled[SEEDS][0].trace, 1), one[1].trace, R)
    assert "vio_xy" in got and all(0 <= t < REPEAT_TICKS
                                   for t in got.values())


@pytest.mark.parametrize("done_at,want", [
    ((3, 7), 9), ((3, 14), 18), ((3, None), 25), ((8, 8), 9), ((9, 9), 18),
    ((24, 0), 25)])
def test_seed_stop_is_the_untiled_runs_first_all_done_boundary(done_at,
                                                               want):
    """25 ticks in chunks of 10 run as 3 chunks of 9: an untiled run stops
    at the first boundary (9, 18) at which every row is done, else runs
    all 25 (two rows, done from the ticks ``done_at``)."""
    assert tcamp.planned_chunks(25, 10) == (3, 9)
    done = np.zeros((2, 25), bool)
    for r, t in enumerate(done_at):
        if t is not None:
            done[r, t:] = True
    assert torch_calibrate.seed_stop(done, 25, 10) == want


def test_seed_two_carry_is_jaxs(taught):
    shared = taught[0]
    data, teach, wps, n_wps = shared
    carry = torch_calibrate.seed_batch(shared, "stock", SEEDS)[-1]
    got = interop.to_numpy_tree(carry)
    R = len(ROUTES)
    jw, jn = jcamp.apply_stock_projection(teach.teach_grid.numpy(),
                                          wps.numpy(), n_wps.numpy(),
                                          jbase.stock_nav2())
    routes = interop.to_numpy_tree(data.routes)
    for i, s in enumerate(SEEDS):
        want = jax.vmap(lambda rt, w, n, s=s: j_init_carry(
            rt, w, n, jbase.stock_nav2(), seed=s))(routes, jw, jn)
        assert np.array_equal(got.key[i * R:(i + 1) * R],
                              np.asarray(want.key))
        for a, b in zip(jax.tree_util.tree_leaves(got.imu),
                        jax.tree_util.tree_leaves(want.imu)):
            assert np.array_equal(a[i * R:(i + 1) * R], np.asarray(b))
    assert not np.array_equal(got.key[:R], got.key[R:])


def test_seed_two_rows_track_jax(taught, seed_runs):
    """Seed 2's rows of the batch against JAX's ``run_campaign_repeat``
    from JAX's seed-2 carry on the same teach, map, waypoints and stores:
    the fixture replays' tolerances (every discrete sequence equal, GT
    within FIX_REPEAT_ATOL_M, nav and VIO within FIX_NAV_ATOL_M)."""
    shared = taught[0]
    data, teach, wps, n_wps = shared
    tiled = seed_runs[0][SEEDS][0]
    R = len(ROUTES)
    j_cfg = jbase.stock_nav2()
    grid = jnp.asarray(teach.teach_grid.numpy())
    jw, jn = jcamp.apply_stock_projection(grid, jnp.asarray(wps.numpy()),
                                          jnp.asarray(n_wps.numpy()), j_cfg)
    routes = interop.to_numpy_tree(data.routes)
    carry = jax.vmap(lambda rt, w, n: j_init_carry(rt, w, n, j_cfg,
                                                   seed=2))(routes, jw, jn)
    jdata = jcamp.CampaignData(None, interop.to_numpy_tree(
        data.scenes_repeat), routes, data.names)
    rep = jcamp.run_campaign_repeat(
        jdata, grid, jw, jn, j_cfg, REPEAT_TICKS,
        stores=interop.to_numpy_tree(teach.store), chunk=CHUNK, carry=carry)
    got = jax.tree_util.tree_map(lambda x: np.asarray(x)[R:], tiled.trace)
    for f in chip_smoke.OURS_DISCRETE + chip_smoke.STOCK_DISCRETE:
        assert np.array_equal(getattr(got, f), np.asarray(
            getattr(rep.trace, f))), f
    for f, atol in (("gt_xy", chip_smoke.FIX_REPEAT_ATOL_M),
                    ("nav_xy", chip_smoke.FIX_NAV_ATOL_M),
                    ("vio_xy", chip_smoke.FIX_NAV_ATOL_M)):
        np.testing.assert_allclose(getattr(got, f),
                                   np.asarray(getattr(rep.trace, f)),
                                   atol=atol, rtol=0, err_msg=f)


def test_seed_checkpoint_refuses_other_seeds(taught, tmp_path):
    """A repeat paused at seeds (1, 2) (after its first 2-tick chunk) is
    not continued at seeds (1, 3)."""
    shared = taught[0]
    ckpt = tmp_path / "stock.ckpt"
    assert torch_calibrate.repeat_phase(
        shared, "stock", 4, 2, ckpt, 0.0, 0.0, None, seeds=SEEDS) is None
    with pytest.raises(SystemExit, match="holds a repeat"):
        torch_calibrate.repeat_phase(shared, "stock", 4, 2, ckpt, 0.0, 0.0,
                                     None, seeds=(1, 3))


@pytest.mark.parametrize("text,want", [
    ("1", (1,)), ("1-8", tuple(range(1, 9))), ("1,3,5", (1, 3, 5)),
    ("1-3,7", (1, 2, 3, 7))])
def test_parse_seeds(text, want):
    assert torch_calibrate.parse_seeds(text) == want


@pytest.mark.parametrize("text", ["", "1,1", "3-1", "a"])
def test_parse_seeds_refuses(text):
    with pytest.raises(Exception):
        torch_calibrate.parse_seeds(text)


# --- the spread test ------------------------------------------------------

def test_bands_and_spread_test_are_the_fixed_ones():
    assert parity.BANDS == {
        "B1": {"modes": ("ours", "rgbd", "stock"), "count": 2},
        "B2": {"modes": ("ours", "rgbd", "stock"), "agree": 12},
        "B3": {"modes": ("ours", "rgbd", "stock"), "points": 6.0},
        "B4": {"modes": ("ours", "rgbd", "stock"), "rel": 0.25,
               "floor_m": 0.5},
        "B5": {"modes": ("ours", "rgbd"), "points": 5.0, "rel": 0.20},
        "B6": {"rel": 0.30, "route_max_m": 1.2},
    }
    assert parity.SPREAD == {"level": 0.99, "max_unseen": 2}


COV = [60.0, 62.0, 58.0, 61.0, 59.5, 63.0, 57.0, 60.5]


def test_prediction_interval_at_k8():
    m, sd, (lo, hi) = parity.prediction_interval(COV)
    assert m == pytest.approx(np.mean(COV))
    assert sd == pytest.approx(np.std(COV, ddof=1))
    h = 3.4995 * sd * np.sqrt(1 + 1 / 8)
    assert (lo, hi) == pytest.approx((m - h, m + h), abs=1e-3)
    assert parity.T995[7] == pytest.approx(3.4995, abs=1e-4)


def seed_tables(jax_table, edit):
    """Eight copies of a JAX table, the k-th edited by ``edit(t, k)``."""
    out = []
    for k in range(8):
        t = copy.deepcopy(jax_table)
        edit(t, k)
        out.append(t)
    return out


def quantity(qs, band, name):
    (q,) = [q for q in qs if q["band"] == band and q["quantity"] == name]
    return q


def set_cov(values):
    def edit(t, k):
        t["agg"]["avg_coverage_pct"] = values[k]
    return edit


@pytest.mark.parametrize("offset,within", [(-1e-6, True), (1e-6, False)],
                         ids=["just_inside", "just_outside"])
def test_scalar_within_spread_at_the_interval_edge(offset, within):
    stock = json.loads((JAX_DIR / "stock.json").read_text())
    _, _, (_, hi) = parity.prediction_interval(COV)
    jax_t = copy.deepcopy(stock)
    jax_t["agg"]["avg_coverage_pct"] = hi + offset
    qs = parity.mode_spread("stock", seed_tables(stock, set_cov(COV)), jax_t)
    assert quantity(qs, "B3", "avg_coverage_pct")["within"] is within


@pytest.mark.parametrize("offset,within", [(0.0, True), (1e-9, False)],
                         ids=["equal", "any_other"])
def test_scalar_spread_with_no_spread(offset, within):
    stock = json.loads((JAX_DIR / "stock.json").read_text())
    jax_t = copy.deepcopy(stock)
    jax_t["agg"]["avg_coverage_pct"] = 61.25 + offset
    qs = parity.mode_spread("stock",
                            seed_tables(stock, set_cov([61.25] * 8)), jax_t)
    q = quantity(qs, "B3", "avg_coverage_pct")
    assert q["sd"] == 0.0 and q["within"] is within


def flip_returns(n_routes):
    """Every seed's ``returned_spawn`` flipped on the first ``n_routes``
    routes, and flipped on one seed only on the next three."""
    def edit(t, k):
        names = list(t["per_route"])
        for n in names[:n_routes]:
            t["per_route"][n]["returned_spawn"] ^= True
        if k == 0:
            for n in names[n_routes:n_routes + 3]:
                t["per_route"][n]["returned_spawn"] ^= True
    return edit


@pytest.mark.parametrize("n_routes,within", [(2, True), (3, False)])
def test_flags_within_spread_at_two_unseen_routes(n_routes, within):
    stock = json.loads((JAX_DIR / "stock.json").read_text())
    qs = parity.mode_spread("stock", seed_tables(stock,
                                                 flip_returns(n_routes)),
                            stock)
    q = quantity(qs, "B2", "returned_spawn")
    names = list(stock["per_route"])
    assert q["unseen"] == names[:n_routes]
    assert q["within"] is within
    assert [q["share_set"][n] for n in names[n_routes:n_routes + 3]] == \
        [7 / 8 if stock["per_route"][n]["returned_spawn"] else 1 / 8
         for n in names[n_routes:n_routes + 3]]


def lower_stock_coverage(mode, t):
    if mode != "stock":
        return t
    t = copy.deepcopy(t)
    t["agg"]["avg_coverage_pct"] -= 20.0
    return t


def write_port(tmp_path, seed_edit, probes=()):
    """A port directory: the JAX tables with stock's coverage 20 points
    lower (B3 missed), stock's seed file from ``seed_edit``, probes."""
    port = jax_tables(tmp_path, lower_stock_coverage)
    stock = json.loads((JAX_DIR / "stock.json").read_text())
    tables = seed_tables(stock, seed_edit)
    for t in tables:
        t["repeat_ticks"] = 100
    (port / parity.SEED_DIR).mkdir()
    (port / parity.SEED_DIR / "stock.json").write_text(json.dumps({
        "mode": "stock", "seeds": list(range(1, 9)), "rows": 120,
        "tables": {str(k + 1): t for k, t in enumerate(tables)}}))
    (port / parity.EVIDENCE).write_text(json.dumps({"probes": list(probes)}))
    return port


def worst_cov_route():
    stock = json.loads((JAX_DIR / "stock.json").read_text())
    return max(stock["per_route"],
               key=lambda n: abs(stock["per_route"][n]["cov_pct"] - 50.0))


def cov_spread(center):
    """Seed tables whose coverage spreads around ``center``, every route's
    cov_pct at 50 % in every seed."""
    def edit(t, k):
        t["agg"]["avg_coverage_pct"] = center + COV[k] - 60.0
        for m in t["per_route"].values():
            m["cov_pct"] = 50.0
    return edit


def probe_at(route, verdict):
    return dict(probe("stock", verdict, parity.NAV), route=route)


@pytest.mark.parametrize("center,probes,want", [
    ("jax", [], "chaos"),
    ("port", [], "outside"),
    ("port", [("other", "chaos")], "outside"),
    ("port", [("worst", "fault")], "fault"),
    ("port", [("worst", "chaos")], "unresolved"),
], ids=["within_chaos", "outside_unprobed", "outside_other_route_probed",
        "outside_probe_fault", "outside_probe_held"])
def test_missed_band_spread_verdict(tmp_path, center, probes, want):
    stock = json.loads((JAX_DIR / "stock.json").read_text())
    jax_cov = stock["agg"]["avg_coverage_pct"]
    worst = worst_cov_route()
    other = next(n for n in stock["per_route"] if n != worst)
    port = write_port(
        tmp_path, cov_spread(jax_cov if center == "jax" else jax_cov - 20.0),
        [probe_at(worst if r == "worst" else other, v) for r, v in probes])
    res = parity.check(port, JAX_DIR)
    (missed,) = [r for r in res["bands"] if not r["held"]]
    assert (missed["band"], missed["mode"]) == ("B3", "stock")
    assert missed["spread"] == want
    (b3,) = [b for b in res["spread"]["bands"]
             if (b["band"], b["mode"]) == ("B3", "stock")]
    assert b3["probe_routes"] == ([] if want == "chaos" else [worst])


def test_held_band_outside_spread_is_listed(tmp_path):
    """JAX's table as the port's: every band held; the seeds' coverage far
    from JAX's lists B3 as held but outside."""
    stock = json.loads((JAX_DIR / "stock.json").read_text())
    port = jax_tables(tmp_path)
    tables = seed_tables(stock, cov_spread(
        stock["agg"]["avg_coverage_pct"] - 20.0))
    for t in tables:
        t["repeat_ticks"] = 100
    (port / parity.SEED_DIR).mkdir()
    (port / parity.SEED_DIR / "stock.json").write_text(json.dumps({
        "mode": "stock", "seeds": list(range(1, 9)), "rows": 120,
        "tables": {str(k + 1): t for k, t in enumerate(tables)}}))
    res = parity.check(port, JAX_DIR)
    assert res["held"]
    assert {"band": "B3", "mode": "stock",
            "outside": ["avg_coverage_pct"]} in res["spread"]["held_outside"]
    assert res["spread"]["witness"]["stock"]["field"] == "cov_pct"
