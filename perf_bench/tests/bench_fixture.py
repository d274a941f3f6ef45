"""A tiny copy of the benchmark for CPU tests: the checkout's
``BENCHMARK.json`` and ``perf_bench/`` copied into a temporary root, with
2 routes, 2 seeds and a short teach, warm-up and window in the copied
configuration and traffic files (the harness finds them by name there)."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

ROUTES = ["08_nw_sw", "01_road"]
TINY = {"seeds": 2, "teach_ticks": 20, "teach_chunk": 10,
        "warm_calls": [2, 3], "trace_ticks": 5, "check_rows": 4}


def tiny_root(tmp: Path) -> Path:
    """A root holding a cut copy of the benchmark's files."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp / "perf_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for f in (tmp / "perf_bench" / "configs").glob("*.json"):
        conf = json.loads(f.read_text())
        conf["routes"] = ROUTES
        f.write_text(json.dumps(conf))
    for f in (tmp / "perf_bench" / "traffic").glob("*.json"):
        traffic = json.loads(f.read_text())
        traffic.update(TINY)
        f.write_text(json.dumps(traffic))
    return tmp


def add_cell(root: Path, name: str, config: str, traffic: str) -> None:
    """Add a cell (and its configuration's entry) to the copy's
    ``BENCHMARK.json``: data only, as a later PR adds one."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    if config not in {c["name"] for c in bench["configs"]}:
        bench["configs"].append(dict(
            bench["configs"][0], name=config,
            file=f"perf_bench/configs/{config}.json"))
    bench["workloads"].append({"name": name, "config": config,
                               "traffic": traffic, "chips": 1,
                               "why": "a test cell"})
    for m in bench["per_layer"]:
        m.setdefault("workloads", []).append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
