"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout, a configuration in ``configs/<name>.json``, a traffic mix in
``traffic/<name>.json`` and a per-layer metric's reader in
``metrics/<name>.py``.  Adding a cell, a configuration, a mix or a metric
adds files and entries; no code here names one."""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass(frozen=True)
class Cell:
    name: str
    config: dict           # the configuration file's contents
    traffic: dict          # the traffic file's contents
    chips: int
    end_to_end: tuple      # the cell's end-to-end metric entries
    per_layer: tuple       # the cell's per-layer metric entries
    root: Path = ROOT      # the checkout that holds it


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _for_cell(metrics, cell_name: str):
    return tuple(m for m in metrics
                 if "workloads" not in m or cell_name in m["workloads"])


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration and
    traffic files read; raises ``KeyError`` for an unknown cell."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / "perf_bench" / "traffic" / f"{w['traffic']}.json")
        .read_text())
    return Cell(name=name, config=conf, traffic=traffic, chips=w["chips"],
                end_to_end=_for_cell(bench["end_to_end"], name),
                per_layer=_for_cell(bench["per_layer"], name), root=root)


def resolve(ref: str):
    """``"package.module:function"`` -> the function (a configuration
    file names its stack's preset this way)."""
    mod, _, attr = ref.partition(":")
    return getattr(importlib.import_module(mod), attr)


def metric_reader(name: str, root: Path = ROOT):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = root / "perf_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perf_bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
