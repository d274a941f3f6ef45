"""CPU tests of the benchmark harness: cells, configurations, traffic and
metrics found by name, the result line, the rate arithmetic, the kernels'
work counts, the seed batch, the imports, and the check failing on a
broken timed path.  Run: ``python -m pytest perf_bench/tests -q``."""

from __future__ import annotations

import ast
import json
import time

import numpy as np
import pytest
import torch

import control_run
from bench_fixture import BENCH, ROUTES, TINY, add_cell, tiny_root
from pbench import campaign, check, roofline, runner, stages
from pbench.spec import find_cell, load_benchmark, metric_reader, resolve
from pbench.trace import DeviceTrace


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    torch.set_num_threads(4)
    return tiny_root(tmp_path_factory.mktemp("bench"))


def run_tiny(root, cell="ours-seeds8", seed=3):
    return runner.run_cell(find_cell(cell, root=root), seed, 0.1, False,
                           "cpu", time.perf_counter())


@pytest.fixture(scope="module")
def ours_out(tiny):
    return run_tiny(tiny)


# --- found by name ---------------------------------------------------------

def test_every_cell_found_by_name():
    bench = load_benchmark()
    for w in bench["workloads"]:
        cell = find_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["name"] == w["traffic"]
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(metric_reader(m["name"]))
    with pytest.raises(KeyError):
        find_cell("no-such-cell")


def test_new_files_found_without_code_change(tiny, tmp_path):
    """A traffic mix, a configuration, a metric and a cell added as files
    and entries are found by name; no code changes."""
    root = tiny_root(tmp_path)
    pb = root / "perf_bench"
    traffic = json.loads((pb / "traffic" / "repeat-seeds8.json").read_text())
    traffic.update(name="repeat-seeds3", seeds=3)
    (pb / "traffic" / "repeat-seeds3.json").write_text(json.dumps(traffic))
    conf = json.loads((pb / "configs" / "ours.json").read_text())
    conf.update(name="ours_copy")
    (pb / "configs" / "ours_copy.json").write_text(json.dumps(conf))
    (pb / "metrics" / "rows_per_tick.py").write_text(
        "def read(ctx):\n    return ctx.get('traced_ticks')\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="ours_copy",
                                 file="perf_bench/configs/ours_copy.json"))
    bench["workloads"].append({"name": "ours-seeds3", "config": "ours_copy",
                               "traffic": "repeat-seeds3", "chips": 1,
                               "why": "a test cell"})
    bench["per_layer"].append({"name": "rows_per_tick", "unit": "rows",
                               "better": "higher", "source": "device_trace",
                               "layer": "test", "moves": "env_steps_per_s",
                               "workloads": ["ours-seeds3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = find_cell("ours-seeds3", root=root)
    assert cell.traffic["seeds"] == 3 and cell.config["name"] == "ours_copy"
    names = [m["name"] for m in cell.per_layer]
    assert "rows_per_tick" in names
    assert metric_reader("rows_per_tick", root=root)({"traced_ticks": 5}) == 5
    # the other cells do not gain the new metric
    assert "rows_per_tick" not in [
        m["name"] for m in find_cell("ours-seeds8", root=root).per_layer]


# --- the result line -------------------------------------------------------

def test_result_line_keys_and_types(ours_out, capsys):
    out = ours_out
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "check"
    assert out["correct"] is True, out["check"]
    assert isinstance(out["attempted"], int) and out["attempted"] > 0
    assert isinstance(out["failed"], int) and out["failed"] == 0
    rows = len(ROUTES) * 2
    assert out["attempted"] % rows == 0
    assert set(out["metrics"]) == {"env_steps_per_s", "setup_s"}
    for m in out["metrics"].values():
        assert isinstance(m["value"], float) and m["value"] > 0
        assert isinstance(m["unit"], str)
    dev = out["device"]
    assert set(dev) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert dev["platform"] == "cpu"     # a CPU run never says "gpu"
    assert set(out["check"]) == set(check.LIMITS)
    runner.report(out)
    cap = capsys.readouterr()
    assert json.loads(cap.out.strip().splitlines()[-1]) == \
        json.loads(json.dumps(out))
    last = cap.err.strip().splitlines()[-len(check.LIMITS):]
    assert all(line.startswith("check ") and " limit " in line
               for line in last)


def test_trace_readers_read_nothing_without_a_trace():
    ctx = {"teach_s": 2.0, "teach_ticks": 400}
    for m in load_benchmark()["per_layer"]:
        v = metric_reader(m["name"])(ctx)
        assert v is None or m["name"] == "teach_ms_per_tick"
    assert metric_reader("teach_ms_per_tick")(ctx) == 5.0


def test_trace_readers_on_a_made_trace():
    # two kernels of 1 ms in a 10 ms window, overlapping by 0.5 ms
    ops = [("relax_kernel", 0, 1_000_000),
           ("cross_check_kernel", 500_000, 1_000_000),
           ("Memcpy DtoH", 4_000_000, 500_000)]
    tr = DeviceTrace(window_s=0.01, ops=ops, runtime_launches=2,
                     shapes={"k1": [(2, 4, 2, 4, 8)], "k2": [(1, 8, 8, 3)]})
    assert tr.busy_s() == pytest.approx(0.002)
    ctx = {"trace": tr, "traced_ticks": 2}
    read = {m["name"]: metric_reader(m["name"])
            for m in load_benchmark()["per_layer"]}
    assert read["launches_per_tick"](ctx) == 1.0
    assert read["device_idle_pct"](ctx) == pytest.approx(80.0)
    k1 = roofline.k1_least_s((2, 4, 2, 4, 8)) / 1e-3 * 100
    assert read["k1_roofline_pct"](ctx) == pytest.approx(k1)
    k2 = roofline.k2_least_s((1, 8, 8, 3))[0] / 1e-3 * 100
    assert read["k2_roofline_pct"](ctx) == pytest.approx(k2)
    gaps = tr.idle_gaps()
    assert gaps[0][1] == pytest.approx(0.0025)
    assert gaps[0][0].endswith("Memcpy DtoH")
    assert tr.top_ops()[0][1] == pytest.approx(0.001)


# --- arithmetic ------------------------------------------------------------

def test_rate_over_executed_ticks():
    assert campaign.env_steps_per_s(120, 20, 110, 27.5) == \
        pytest.approx(120 * 20 * 110 / 27.5)
    # the window: whole 5-tick periods nearest to seconds / s a tick
    assert campaign.window_ticks(30.0, 0.27, 5) == 110
    assert campaign.window_ticks(30.0, 0.2, 5) == 150
    assert campaign.window_ticks(0.1, 0.2, 5) == 5
    assert campaign.window_ticks(10.0, 0.26, 5) == 40


def test_kernel_counts_by_hand():
    # K1: one problem of 2 a-rows against 3 b-rows of 8 words
    assert roofline.k1_bytes(1, 2, 1, 3, 8) == \
        8 * 8 * 2 + 8 * 8 * 3 + 2 + 3 + 2 * (4 + 4 + 1)
    assert roofline.k1_ops(1, 2, 1, 3, 8) == 3 * 2 * 3 * 8
    # the matcher's shape: 5 candidates a route share the route's b set
    assert roofline.k1_bytes(10, 256, 2, 256, 8) == \
        64 * (10 * 256 + 2 * 256) + 10 * 256 + 2 * 256 + 9 * 10 * 256
    # K2: 2 grids of 3 x 4 cells, 5 iterations
    assert roofline.k2_bytes(2, 3, 4) == 3 * 4 * 24
    assert roofline.k2_ops(2, 3, 4, 5) == 18 * 24 * 5
    t, by = roofline.k2_least_s((120, 192, 192, 384))
    assert by == "operations"
    assert t == pytest.approx(18 * 120 * 192 * 192 * 384 / 67e12)
    t, by = roofline.k2_least_s((1, 192, 192, 0))
    assert by == "bytes"


def test_repeat_seeds_of_large_seeds():
    assert campaign.repeat_seeds(1, 8) == tuple(range(1, 9))
    assert campaign.repeat_seeds(2, 8) == tuple(range(9, 17))
    big = 2 ** 31 + 5
    s = campaign.repeat_seeds(big, 8)
    assert len(set(s)) == 8 and all(0 <= x < 2 ** 32 for x in s)
    assert s == campaign.repeat_seeds(big, 8)
    rows = campaign.sample_rows(big, 120, 15)
    assert len(rows) == 15 and rows.unique().numel() == 15
    assert torch.equal(rows, campaign.sample_rows(big, 120, 15))


def test_seed_batch_tiling(tiny):
    """2 routes x 2 seeds: seed-major rows, each block the untiled carry
    of its seed, every row's teach inputs its route's."""
    from nclt_slam_tpu_torch.rollout.repeat import init_repeat_carry
    from pbench.trees import leaves

    cell = find_cell("ours-seeds8", root=tiny)
    traffic = dict(cell.traffic, warm_calls=[])
    rows = torch.arange(4)
    s = campaign.set_up(cell.config, traffic, 5, "cpu", rows)
    assert s.seeds == (9, 10)
    assert s.big.names == ("08_nw_sw@drops", "01_road@drops") * 2
    assert s.sample.routes == tuple(ROUTES) * 2
    assert s.sample.seeds == (9, 9, 10, 10)
    assert torch.equal(s.grid[:2], s.grid[2:])
    assert torch.equal(s.wps[:2], s.wps[2:])
    for k, seed in enumerate(s.seeds):
        alone = init_repeat_carry(s.data.routes, s.wps[:2], s.n_wps[:2],
                                  s.cfg, seed=seed)
        for (name, a), (_, b) in zip(leaves(s.carry), leaves(alone)):
            assert torch.equal(a[2 * k:2 * k + 2], b), name


# --- imports ---------------------------------------------------------------

def _imports(path):
    tree = ast.parse(path.read_text())
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            yield from (a.name for a in n.names)
        elif isinstance(n, ast.ImportFrom) and n.module and not n.level:
            yield n.module
        elif isinstance(n, ast.Call) and getattr(n.func, "attr", "") == \
                "import_module" and n.args and \
                isinstance(n.args[0], ast.Constant):
            yield n.args[0].value


def test_no_jax_and_reference_stands_alone():
    forbidden = {"jax", "jaxlib", "flax", "nclt_slam_tpu"}
    for path in BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & forbidden, (path, tops & forbidden)
    for path in [*(BENCH / "refsim").rglob("*.py"),
                 *(BENCH / "plainref").rglob("*.py")]:
        tops = {m.split(".")[0] for m in _imports(path)}
        assert "nclt_slam_tpu_torch" not in tops, path
        assert not any("nclt_slam_tpu" in line and "import" in line
                       for line in path.read_text().splitlines()), path
    # the stage references stand apart from the frozen copy too
    for path in (BENCH / "plainref").rglob("*.py"):
        assert "refsim" not in {m.split(".")[0] for m in _imports(path)}
    # check.py drives the reference only
    tops = {m.split(".")[0] for m in _imports(BENCH / "pbench" / "check.py")}
    assert "nclt_slam_tpu_torch" not in tops
    # whole names: the port's name begins with the JAX package's
    assert "nclt_slam_tpu_torch".split(".")[0] not in forbidden


def test_run_loads_no_jax(ours_out):
    assert runner.forbidden_modules() == []


# --- the check fails on a broken timed path --------------------------------

def _fault_run(tiny, monkeypatch, make_step):
    import nclt_slam_tpu_torch.rollout.repeat as repeat
    monkeypatch.setattr(repeat, "repeat_step", make_step(repeat.repeat_step))
    return run_tiny(tiny)


def test_fault_state_unchanged(tiny, monkeypatch):
    def make(step):
        def broken(carry, *a, **kw):
            _, tr = step(carry, *a, **kw)
            return carry, tr
        return broken
    out = _fault_run(tiny, monkeypatch, make)
    assert out["correct"] is False and out["failed"] > 0


def test_fault_half_batch_left_out(tiny, monkeypatch):
    from pbench.trees import cat_rows, take_rows

    def make(step):
        def broken(carry, *a, **kw):
            B = carry.cmd.shape[0]
            new, tr = step(carry, *a, **kw)
            keep = torch.arange(B // 2, B)
            half = take_rows(carry, keep)
            return cat_rows([take_rows(new, torch.arange(B // 2)),
                             half]), tr
        return broken
    out = _fault_run(tiny, monkeypatch, make)
    assert out["correct"] is False and out["failed"] > 0


def test_fault_answer_altered(tiny, monkeypatch):
    def make(step):
        def broken(carry, tick, *a, **kw):
            new, tr = step(carry, tick, *a, **kw)
            if tick == 7:       # one row's pose, one tick, 1 cm
                xy = new.robot.xy.clone()
                xy[0, 0] += 1e-2
                new = new._replace(robot=new.robot._replace(xy=xy))
            return new, tr
        return broken
    out = _fault_run(tiny, monkeypatch, make)
    assert out["correct"] is False


def test_control_bf16_fails(tiny):
    """The reference's campaign with its state rounded to bfloat16 in the
    program's place fails the check."""
    out = control_run.campaign_controls(find_cell("ours-seeds8", root=tiny),
                                        (3,), 5, ("bf16",), "cpu")
    assert [d["correct"] for d in out] == [False]


def test_fault_teach_late_tick(tiny, monkeypatch):
    """A teach that goes wrong one tick before its end alone fails the
    check."""
    import nclt_slam_tpu_torch.rollout.teach as teach

    step = teach.teach_step
    last = TINY["teach_ticks"] - 2

    def broken(carry, tick, *a, **kw):
        new, tr = step(carry, tick, *a, **kw)
        if tick == last:
            xy = new.robot.xy.clone()
            xy[0, 0] += 1e-2
            new = new._replace(robot=new.robot._replace(xy=xy))
        return new, tr
    monkeypatch.setattr(teach, "teach_step", broken)
    out = run_tiny(tiny)
    assert out["correct"] is False
    assert out["check"]["teach_mismatch"]["value"] > 0


def test_fault_store_corrupt(tiny, monkeypatch):
    """A teach that writes one wrong word into a landmark store fails the
    check."""
    import nclt_slam_tpu_torch.rollout.campaign as camp

    run = camp.run_campaign_teach

    def broken(*a, **kw):
        res = run(*a, **kw)
        desc = res.store.desc.clone()
        desc.view(-1)[0] ^= 1
        return res._replace(store=res.store._replace(desc=desc))
    monkeypatch.setattr(camp, "run_campaign_teach", broken)
    out = run_tiny(tiny)
    assert out["correct"] is False
    assert out["check"]["teach_mismatch"]["value"] > 0


def test_stages_held_to_plain_references(tiny):
    """The program's recorded stages read within their limits, and the
    control in their place (inputs rounded to bfloat16, K1 on half the
    bits) reads over them, number by number."""
    cell = find_cell("ours-seeds8", root=tiny)
    rows = torch.arange(4)
    s = campaign.set_up(cell.config, cell.traffic, 6, "cpu", rows)
    campaign.window(s, 5, cell.traffic["repeat_chunk"], "cpu", 5)
    ref_cfg = resolve(cell.config["reference_preset"])()
    assert {k.split(".")[0] for k in s.stages} == set(stages.STAGES)
    sound = stages.stage_numbers(s.stages, cell.config["stages"], ref_cfg)
    ctl = stages.stage_numbers(control_run.control_calls(s.stages, ref_cfg),
                               cell.config["stages"], ref_cfg)
    for name, v in sound.items():
        assert v <= check.LIMITS[name], (name, v)
        assert ctl[name] > check.LIMITS[name], (name, ctl[name])


def test_window_past_a_chunk(tmp_path):
    """A window of 5 ticks in chunks of 3 executes 6 ticks and traces 5:
    the reference runs the same 5, and the run checks correct."""
    root = tiny_root(tmp_path)
    path = root / "perf_bench" / "traffic" / "repeat-seeds8.json"
    traffic = json.loads(path.read_text())
    traffic.update(repeat_chunk=3)
    path.write_text(json.dumps(traffic))
    out = run_tiny(root)
    assert out["correct"] is True, out["check"]
    assert out["attempted"] == len(ROUTES) * 2 * 6


def test_reference_teach_kept_once(tiny, tmp_path):
    """The reference's teach is computed once into its cache directory and
    read back the same, element for element; a control's is never kept."""
    cell = find_cell("ours-seeds8", root=tiny)
    conf, tr = cell.config, cell.traffic
    first = check.reference_teach(conf, tr, "cpu", cache_dir=tmp_path)
    kept = list(tmp_path.glob("teach-*.pt"))
    assert len(kept) == 1
    again = check.reference_teach(conf, tr, "cpu", cache_dir=tmp_path)
    assert check.teach_numbers(again.teach, first) == {"teach_mismatch": 0}
    check.reference_teach(conf, tr, "cpu", tick_hook=lambda c: c,
                          cache_dir=tmp_path)
    assert list(tmp_path.glob("teach-*")) == kept


def test_stock_cell_correct(tmp_path):
    """The stock configuration (kept for a later cell, §7 of PERF.md) runs
    and checks correct through the same harness, added as data."""
    root = tiny_root(tmp_path)
    add_cell(root, "stock-seeds8", "stock", "repeat-seeds8")
    out = run_tiny(root, cell="stock-seeds8", seed=4)
    assert out["correct"] is True, out["check"]


@pytest.mark.cuda
def test_control_tf32_fails_on_card(tmp_path):
    """On the card, the reference with TF32 on in the program's place
    fails the check (at the cut size; the cell's size is in PERF.md)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    root = tiny_root(tmp_path)
    out = control_run.campaign_controls(find_cell("ours-seeds8", root=root),
                                        (3,), 5, ("tf32",), "cuda")
    assert out[0]["correct"] is False
    assert np.isfinite(out[0]["check"]["nav_gap_m"]["value"])
