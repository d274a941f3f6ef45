#!/usr/bin/env python3
"""What the fused descent costs the planner: ``planning/wavefront.py``'s
``plan_window`` at the rollout's shape (15 routes, a 192 x 192 window,
256 descent steps) timed with the descent's ``phi[n] + scale * tc[x]``
fused (``_fma32``, as the JAX package's compiled descent rounds it) and
with two float32 roundings, in the order A B B A, each the median of
``--iters`` calls (host clock around calls that end in a synchronize).

    python3 tools/torch_descent_probe.py [--device cuda] [--iters 20] \\
        [--out runs/descent_probe.json]

Prints one JSON line: the card's ``nvidia-smi`` name and power limit, ms a
call of each variant, and how many routes' paths the two variants tell
apart on these windows.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from nclt_slam_tpu_torch.config import DEFAULT  # noqa: E402
from nclt_slam_tpu_torch.planning import wavefront as wf  # noqa: E402


def card() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def windows(B: int, W: int, dev):
    """Open ground (cost 0) with a tenth of the cells inflated and a few
    lethal blocks; start and goal 150 cells apart."""
    g = torch.Generator().manual_seed(0)
    cost = torch.zeros(B, W, W)
    cost[torch.rand(B, W, W, generator=g) < 0.1] = 40.0
    for i in range(B):
        r, c = (int(x) for x in torch.randint(20, W - 40, (2,), generator=g))
        cost[i, r:r + 12, c:c + 12] = 99.0
    start = (torch.full((B,), 20, dtype=torch.int32),
             torch.full((B,), 20, dtype=torch.int32))
    goal = (torch.full((B,), W - 20, dtype=torch.int32),
            torch.full((B,), W - 30, dtype=torch.int32))
    return (cost.to(dev), tuple(x.to(dev) for x in start),
            tuple(x.to(dev) for x in goal))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--routes", type=int, default=15)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no card: pass --device cpu")
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    pc = DEFAULT.planner
    cost, start, goal = windows(args.routes, pc.window, dev)
    fused = wf._fma32
    variants = {"fused": fused, "two_roundings": lambda a, b, c: c + a * b}

    def call(name):
        wf._fma32 = variants[name]
        try:
            return wf.plan_window(cost, start, goal, DEFAULT.map, pc)
        finally:
            wf._fma32 = fused

    paths = {k: call(k).path_xy for k in variants}     # warm-up and build
    ms = {k: [] for k in variants}
    for name in ("fused", "two_roundings", "two_roundings", "fused"):
        for _ in range(args.iters):
            sync()
            t0 = time.perf_counter()
            call(name)
            sync()
            ms[name].append((time.perf_counter() - t0) * 1e3)
    differ = (paths["fused"] != paths["two_roundings"]).any(-1).any(-1)
    res = {"card": card() if dev.type == "cuda" else None,
           "device": str(dev), "routes": args.routes, "window": pc.window,
           "path_len": pc.path_len,
           "ms_per_call": {k: statistics.median(v) for k, v in ms.items()},
           "routes_whose_path_differs": int(differ.sum())}
    line = json.dumps(res)
    print(line)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
