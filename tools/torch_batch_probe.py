#!/usr/bin/env python3
"""Whether a repeat row of the PyTorch port depends on how many rows its
batch holds (the seed axis of ``tools/torch_calibrate.py --seeds``).

Off a teach checkpoint (``tools/torch_calibrate.py --mode teach
--teach-ckpt PATH``) it runs one mode's repeat for ``--ticks``: untiled
twice (is the run deterministic?), then at seeds (1, 2) and at
``--seeds`` as batch rows (``torch_calibrate.seed_batch``), and prints the
first tick at which each trace field of seed 1's rows differs from the
untiled run's.  Where the largest batch differs, it steps that batch again
and, from a few ticks before the first difference, runs every torch call
of the repeat tick a second time on the first R rows of its batch-leading
arguments alone (a ``TorchFunctionMode``): each call site whose first R
rows come out otherwise is printed with its shapes and largest
difference.  On the CPU that finds ATen's vectorized ``atan2``, whose
scalar tail rounds otherwise than its vector body.

    python3 tools/torch_batch_probe.py --mode rgbd --ticks 600 \\
        --seeds 1-4 --teach-ckpt runs/teach.ckpt \\
        --out runs/batch_probe.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))
import torch_calibrate  # noqa: E402

# ticks before the first difference at which the calls are checked
LEAD = 8


class RowCheck(TorchFunctionMode):
    """Runs each torch call whose output leads with ``n`` rows again on the
    first ``r`` rows of its ``n``-row arguments; records the call sites
    whose first ``r`` rows differ."""

    def __init__(self, r: int, n: int):
        super().__init__()
        self.r, self.n, self.found, self.inside = r, n, [], False

    def _cut(self, x):
        if isinstance(x, torch.Tensor) and x.dim() and x.shape[0] == self.n:
            return x[:self.r]
        if isinstance(x, (list, tuple)):
            return type(x)(self._cut(y) for y in x)
        return x

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.inside or not (isinstance(out, torch.Tensor) and out.dim()
                               and out.shape[0] == self.n):
            return out
        self.inside = True
        try:
            ref = func(*self._cut(args),
                       **{k: self._cut(v) for k, v in kwargs.items()})
        except (RuntimeError, TypeError, ValueError, IndexError):
            ref = None
        finally:
            self.inside = False
        if isinstance(ref, torch.Tensor) and ref.shape == out[:self.r].shape \
                and not torch.equal(ref, out[:self.r]):
            stack = traceback.extract_stack()[:-1]
            site = next((f for f in reversed(stack)
                         if "nclt_slam_tpu_torch" in f.filename), stack[-1])
            self.found.append({
                "call": getattr(func, "__name__", str(func)),
                "site": f"{Path(site.filename).relative_to(REPO)}:"
                        f"{site.lineno} {site.name}",
                "shapes": [list(a.shape) for a in args
                           if isinstance(a, torch.Tensor)],
                "max_abs_diff": float((ref.double()
                                       - out[:self.r].double()).abs().max())})
        return out


def first_differences(trace, ref, rows: int) -> dict:
    """Field -> the first tick at which the first ``rows`` rows of
    ``trace`` differ from ``ref``'s."""
    out = {}
    for f in trace._fields:
        a = np.asarray(getattr(trace, f))[:rows]
        b = np.asarray(getattr(ref, f))[:rows]
        bad = np.flatnonzero((a != b).reshape(rows, a.shape[1], -1)
                             .any(-1).any(0))
        if len(bad):
            out[f] = int(bad[0])
    return out


def batch_dependent_calls(shared, mode: str, seeds, start: int, stop: int):
    """The call sites of the repeat tick whose first R rows differ at
    ``len(seeds) * R`` rows from R rows, over ticks [start, stop)."""
    from nclt_slam_tpu_torch.rollout.repeat import repeat_step

    big, grid, _, _, stores, carry = torch_calibrate.seed_batch(
        shared, mode, seeds)
    cfg = torch_calibrate.mode_config(mode)
    r = len(shared[0].names)
    sites = {}
    for t in range(stop):
        check = RowCheck(r, r * len(seeds))
        if t >= start:
            with check:
                carry, _ = repeat_step(carry, t, big.scenes_repeat,
                                       big.routes, grid, stores, cfg)
        else:
            carry, _ = repeat_step(carry, t, big.scenes_repeat, big.routes,
                                   grid, stores, cfg)
        for row in check.found:
            sites.setdefault((row["call"], row["site"]), dict(row, tick=t))
    return list(sites.values())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="rgbd", choices=torch_calibrate.MODES)
    ap.add_argument("--ticks", type=int, default=600)
    ap.add_argument("--seeds", type=torch_calibrate.parse_seeds,
                    default=(1, 2, 3, 4))
    ap.add_argument("--routes", default="all")
    ap.add_argument("--teach-ticks", type=int, default=12000)
    ap.add_argument("--teach-ckpt", required=True)
    ap.add_argument("--chunk", type=int, default=250)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)

    from nclt_slam_tpu_torch.scene.routes import ALL_ROUTES

    routes = (list(ALL_ROUTES) if args.routes == "all"
              else args.routes.split(","))
    card = torch_calibrate.card_line(args.device)
    shared, _ = torch_calibrate.teach_phase(
        routes, args.teach_ticks, args.device, args.teach_ckpt, args.chunk,
        card)
    sync = (torch.cuda.synchronize if torch.device(args.device).type ==
            "cuda" else (lambda: None))
    runs = {}
    for name, seeds in (("untiled", (1,)), ("untiled_again", (1,)),
                        ("seeds_1_2", (1, 2)), ("seeds", args.seeds)):
        t0 = time.perf_counter()
        rep, _ = torch_calibrate.repeat_phase(
            shared, args.mode, args.ticks, args.chunk, None, None, 0.0, None,
            seeds=seeds)
        sync()
        runs[name] = rep.trace
        print(f"{args.mode} at seeds {seeds}: {args.ticks} ticks in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    r = len(shared[0].names)
    res = {"mode": args.mode, "ticks": args.ticks, "seeds": args.seeds,
           "card": card,
           "first_difference": {
               k: first_differences(runs[k], runs["untiled"], r)
               for k in ("untiled_again", "seeds_1_2", "seeds")}}
    for k, v in res["first_difference"].items():
        print(f"seed 1's rows, {k} against untiled: "
              f"{json.dumps(v) if v else 'bit-equal'}", flush=True)
    first = res["first_difference"]["seeds"]
    if first:
        t = min(first.values())
        res["calls"] = batch_dependent_calls(
            shared, args.mode, args.seeds, max(t - LEAD, 0), t + 1)
        for c in res["calls"]:
            print(f"batch-dependent: {c['call']} at {c['site']} (tick "
                  f"{c['tick']}, shapes {c['shapes']}, max diff "
                  f"{c['max_abs_diff']:.3g})", flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1) + "\n")
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
