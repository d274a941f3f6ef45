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
"""

import copy
import json
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
import torch_calibrate  # noqa: E402
import torch_campaign_parity as parity  # noqa: E402

torch.set_num_threads(1)

ROUTES = ("08_nw_sw", "01_road")
TEACH_TICKS = 210
REPEAT_TICKS = 20
CHUNK = 10
JAX_DIR = REPO / "artifacts" / "calibration"
CARD_DIR = REPO / "artifacts" / "calibration_torch"
JAX_KEYS = ("mode", "per_route", "agg", "teach_drift", "anchor")


@pytest.fixture(scope="module")
def taught(tmp_path_factory):
    """One teach through the tool's own path, written to its checkpoint."""
    ckpt = tmp_path_factory.mktemp("calibrate") / "teach.ckpt"
    shared, meta = torch_calibrate.teach_phase(
        list(ROUTES), TEACH_TICKS, "cpu", ckpt, CHUNK, None)
    assert ckpt.is_file()
    return shared, meta, ckpt


@pytest.mark.parametrize("mode", ["ours", "stock"])
def test_split_path_writes_the_one_call_table(taught, mode, tmp_path,
                                              monkeypatch):
    shared, meta, ckpt = taught
    (names, per_route, agg, drift, anchor), _, rep = torch_calibrate.run(
        None, mode, TEACH_TICKS, REPEAT_TICKS, "cpu", shared=shared,
        chunk=CHUNK)
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
    them now (bands, verdicts and the attached probe evidence)."""
    want = json.loads((CARD_DIR / "parity.json").read_text())
    got = json.loads(json.dumps(parity.check(CARD_DIR, JAX_DIR)))
    assert got == want
