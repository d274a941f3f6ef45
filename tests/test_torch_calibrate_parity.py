"""``tools/torch_campaign_parity.py``, the campaign parity check, and the
committed card tables.  It needs no teach.

- Every band holds on a JAX table against itself; three reach flips miss
  B1 alone, coverage moved by 7 points misses B3 alone; a missed band is
  "chaos" only where its mode's probes held and ran every stage that
  decides it, "fault" where one found a stage that differs, else
  "unresolved"; the encoder table is reported, never banded.
- The committed card tables (``artifacts/calibration_torch``) have the JAX
  tool's schema and 15 routes.
- The spread test (``torch_campaign_parity.SPREAD``) on hand-made seed
  tables: the 99 % prediction interval at K = 8, a value just inside and
  just outside it, s = 0, two against three unseen routes, a missed band's
  verdict from chaos through outside to fault or unresolved; ``BANDS``
  and ``SPREAD`` still the values fixed before the card runs.
- The route rule against JAX's own CPU runs (``route_rule``, ``--ref-cpu``)
  on hand-made drifts, one case a verdict, and through ``check`` on
  hand-made seed files; the committed ``jax_cpu/`` files run off the
  committed teach.
"""

import copy
import json

import numpy as np
import pytest

from torch_calibrate_common import CARD_DIR, JAX_DIR, JAX_KEYS, SEED_DIR
import torch_campaign_parity as parity  # noqa: E402

CPU_DIR = "jax_cpu"
FOUR = ("03_south", "05_ne_sw", "08_nw_sw", "11_nw_mid")


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
    got = json.loads(json.dumps(parity.check(CARD_DIR, JAX_DIR,
                                             CARD_DIR / CPU_DIR)))
    assert got == want
    assert set(want["cpu_reference"]) == {"ours"}
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


# --- the route rule against JAX's own CPU runs ---------------------------

PORT8 = [1.0, 1.2, 1.4, 1.6, 1.8, 2.0, 2.2, 2.4]


@pytest.mark.parametrize("cpu,tpu,cpu_reach,want", [
    # two routes with every JAX seed above every port seed
    ({"a": [2.5, 3.0], "b": [2.6, 2.7], "c": [1.5, 2.0], "d": [1.1, 1.2]},
     {"a": 9.0, "b": 9.0, "c": 9.0, "d": 9.0}, None, "fault"),
    # one systematic route each way: not the same direction
    ({"a": [2.5, 3.0], "b": [0.5, 0.7], "c": [1.5, 2.0], "d": [1.1, 1.2]},
     {"a": 9.0, "b": 9.0, "c": 9.0, "d": 9.0}, None, "chaos"),
    # no route systematic, the TPU above both on two routes
    ({"a": [1.5, 2.9], "b": [1.1, 2.0], "c": [1.5, 2.0], "d": [1.1, 1.2]},
     {"a": 9.0, "b": 3.0, "c": 2.0, "d": 1.3}, None, "platform"),
    # no route systematic, the TPU outside on one route only
    ({"a": [1.5, 2.9], "b": [1.1, 2.0], "c": [1.5, 2.0], "d": [1.1, 1.2]},
     {"a": 9.0, "b": 2.0, "c": 2.0, "d": 1.3}, None, "chaos"),
    # the reach route: every JAX seed short of the end, every port seed there
    ({"a": [1.5, 2.9], "b": [1.1, 2.0], "c": [1.5, 2.0], "d": [1.1, 1.2]},
     {"a": 9.0, "b": 3.0, "c": 2.0, "d": 1.3}, [False, False], "fault"),
    # one JAX seed reaches it: no split
    ({"a": [1.5, 2.9], "b": [1.1, 2.0], "c": [1.5, 2.0], "d": [1.1, 1.2]},
     {"a": 9.0, "b": 3.0, "c": 2.0, "d": 1.3}, [False, True], "platform"),
], ids=["fault_two_routes_above", "chaos_opposite_directions", "platform",
        "chaos_tpu_outside_once", "fault_reach_route_split",
        "platform_reach_route_shared"])
def test_route_rule(cpu, tpu, cpu_reach, want):
    port = {n: list(PORT8) for n in cpu}
    reach_p = {parity.REACH_ROUTE: [True] * 8}
    reach_c = {} if cpu_reach is None else {parity.REACH_ROUTE: cpu_reach}
    res = parity.route_rule(port, cpu, tpu, reach_p, reach_c)
    assert res["verdict"] == want
    if want == "fault" and cpu_reach is None:
        assert res["systematic"] == {"a": "jax_above", "b": "jax_above"}
    if cpu_reach is not None:
        assert res["reach_route"]["split"] is (not any(cpu_reach))


def test_route_rule_is_the_fixed_one():
    assert parity.ROUTE_RULE == {"quantity": "drift_mean",
                                 "same_direction": 2, "tpu_outside": 2,
                                 "reach_route": "08_nw_sw"}


def four_route_table(ours, drift, reached=True, events=True):
    """JAX's ours table cut to the four routes, each route's drift set."""
    t = copy.deepcopy(ours)
    t["per_route"] = {n: dict(t["per_route"][n], drift_mean=drift[n],
                              reached_final=reached) for n in FOUR}
    t["anchor"] = {n: t["anchor"][n] for n in FOUR}
    t["teach_drift"] = {n: t["teach_drift"][n] for n in FOUR}
    if events:
        t["events"] = {n: {"snaps": 1, "jumps": 2} for n in FOUR}
    return t


@pytest.mark.parametrize("jax_cpu_drift,want", [(0.5, "platform"),
                                                (20.0, "fault")])
def test_ref_cpu_section(tmp_path, jax_cpu_drift, want):
    """``check`` with ``--ref-cpu``: JAX's CPU seed file and the port's seed
    file at the four routes give the route rule's verdict, the events of
    both and, for ours' band outside the port's spread (its drift, 20 m
    off the seeds), where the CPU runs lie."""
    ours = json.loads((JAX_DIR / "ours.json").read_text())
    (tmp_path / "port").mkdir()
    port = jax_tables(tmp_path / "port")
    seeds = [dict(copy.deepcopy(ours), repeat_ticks=100) for _ in range(8)]
    for k, t in enumerate(seeds):
        t["agg"]["avg_drift_mean"] += 20.0 + 0.1 * k
    (port / parity.SEED_DIR).mkdir()
    (port / parity.SEED_DIR / "ours.json").write_text(json.dumps({
        "mode": "ours", "seeds": list(range(1, 9)), "rows": 120,
        "tables": {str(k + 1): t for k, t in enumerate(seeds)}}))
    cpu = tmp_path / CPU_DIR
    cpu.mkdir()
    tpu = {n: ours["per_route"][n]["drift_mean"] for n in FOUR}
    low = min(tpu.values()) / 10
    pt = {str(s): four_route_table(
        ours, {n: low * (1 + 0.01 * s) for n in FOUR}) for s in range(1, 9)}
    (cpu / "port_seeds_1_8.json").write_text(json.dumps(
        {"mode": "ours", "seeds": list(range(1, 9)), "tables": pt}))
    jt = {str(s): four_route_table(
        ours, {n: low * jax_cpu_drift * 2 * (1 + 0.01 * s) for n in FOUR})
        for s in (1, 2)}
    (cpu / "ours.json").write_text(json.dumps(
        {"mode": "ours", "seeds": [1, 2], "routes": list(FOUR),
         "tables": jt, "platform": "cpu"}))
    res = parity.check(port, JAX_DIR, cpu)
    c = res["cpu_reference"]["ours"]
    assert c["port_seeds"] == list(range(1, 9)) and c["teach_equal"]
    assert c["port_sources"] == ["port_seeds_1_8.json"]
    assert c["verdict"] == want
    if want == "platform":
        assert c["systematic"] == {} and len(c["tpu_outside"]) >= 2
    else:
        assert set(c["systematic"].values()) == {"jax_above"}
    assert c["events"]["03_south"]["jax_cpu"] == {"snaps": [1, 1],
                                                  "jumps": [2, 2]}
    (b4,) = [b for b in c["bands"] if b["band"] == "B4"]
    assert set(b4["routes"]) == set(FOUR)
    assert parity.main(["--port-dir", str(port), "--ref-dir", str(JAX_DIR),
                        "--ref-cpu", str(cpu)]) == 0
    assert json.loads((port / "parity.json").read_text())[
        "cpu_reference"]["ours"]["verdict"] == want


def test_committed_jax_cpu_files_have_the_schema():
    """JAX's CPU tables and the port's seed tables at the four routes, run
    off the committed tables' teach: JAX's table keys and the events per
    route, the executed ticks, wall seconds and the CPU or card line."""
    d = CARD_DIR / CPU_DIR
    teach = json.loads((CARD_DIR / "ours.json").read_text())["teach_drift"]
    ref = json.loads((d / "ours.json").read_text())
    assert ref["platform"] == "cpu" and ref["jax_version"]
    assert ref["cpu"]["model"] and ref["cpu"]["cores"] >= 1
    assert ref["routes"] == list(FOUR) and len(ref["seeds"]) >= 2
    assert "H100" in ref["teach_meta"]["card"]
    files = [ref] + [json.loads(f.read_text())
                     for f in sorted(d.glob("port_seeds*.json"))]
    assert len(files) >= 2
    for f in files:
        assert f["mode"] == "ours"
        assert 0 < f["ticks_executed"]["repeat"] <= 12000
        assert f["wall_s"]["repeat"] > 0
        for t in f["tables"].values():
            assert set(JAX_KEYS) <= set(t)
            assert set(FOUR) <= set(t["per_route"])
            assert {n: t["teach_drift"][n] for n in FOUR} == \
                {n: teach[n] for n in FOUR}
            assert set(FOUR) <= set(t["events"])
            assert 0 < t["repeat_ticks"] <= f["ticks_executed"]["repeat"]
    for f in files[1:]:
        assert "H100" in f["card"]["teach"]
        assert all("H100" in c for c in f["card"]["repeat"])


def test_teach_card_names_only_the_same_teach(tmp_path):
    """``--teach-card``: a table (and a seed file) of the recorded teach
    that names no card takes the record's card line; a table of another
    teach is refused."""
    ours = json.loads((JAX_DIR / "ours.json").read_text())
    drift = ours["teach_drift"]
    record = tmp_path / "teach.json"
    record.write_text(json.dumps({"teach_drift": drift, "teach_meta": {
        "card": "NVIDIA H100 80GB HBM3, 700.00 W"}}))
    port = tmp_path / "port"
    (port / parity.SEED_DIR).mkdir(parents=True)
    table = dict(ours, card={"teach": None, "repeat": ["x"]})
    (port / "ours.json").write_text(json.dumps(table))
    (port / "stock.json").write_text(json.dumps(
        dict(table, card={"teach": "named", "repeat": ["x"]})))
    (port / parity.SEED_DIR / "ours.json").write_text(json.dumps(
        {"mode": "ours", "seeds": [1], "tables": {"1": ours},
         "card": {"teach": None, "repeat": ["x"]}}))
    got = parity.adopt_teach_card(port, record)
    assert [f.name for f in got] == ["ours.json", "ours.json"]
    for f in (port / "ours.json", port / parity.SEED_DIR / "ours.json"):
        card = json.loads(f.read_text())["card"]
        assert card["teach"] == "NVIDIA H100 80GB HBM3, 700.00 W"
        assert card["teach_from"] == "teach.json"
    assert json.loads((port / "stock.json").read_text())["card"][
        "teach"] == "named"
    other = copy.deepcopy(table)
    first = next(iter(other["teach_drift"]))
    other["teach_drift"][first] = [9.0, 9.0]
    (port / "rgbd.json").write_text(json.dumps(other))
    with pytest.raises(SystemExit, match="another teach"):
        parity.adopt_teach_card(port, record)
