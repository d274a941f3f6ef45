"""The controls of the check at a cell's own size, on the card.  Each puts
a lower-precision or nudged copy of a reference in the program's place
and reads the check's numbers, which give the upper readings of the
limits in ``pbench/check.py`` (``PERF.md`` section 2):

- ``stages``: the program's set-up at the cell's size and the window's
  first ticks, in which its stages are recorded (``pbench/stages.py``);
  each is read twice: the program's own output
  (a sound reading) and ``plainref`` on its inputs rounded to bfloat16,
  for K1 on descriptors with the low 16 bits of every word cleared (the
  control);
- ``tf32``: the reference's whole campaign with TF32 on in its matmuls
  (the configuration states float32 with TF32 off);
- ``bf16``: the reference's campaign with its state rounded to bfloat16
  after every tick;
- ``ulp``: the reference's campaign with every checked row's position
  moved by one float32 step at the window's first tick: a difference of
  rounding alone, the witness of what a sound change of summation order
  reads.

    python3 perf_bench/tests/control_run.py --workload ours-seeds8 \\
        --seeds 5,6,7 --window-ticks 130 --controls stages,tf32,ulp

Prints a JSON line for each control and seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from pbench import campaign, check, stages  # noqa: E402
from pbench.runner import required_numbers  # noqa: E402
from pbench.spec import find_cell, resolve  # noqa: E402
from pbench.trees import map_floats  # noqa: E402
from plainref import dynamics, hamming, imu, wavefront  # noqa: E402


def _bf16(tree):
    return map_floats(tree, lambda t: t.to(torch.bfloat16).to(t.dtype))


def _np(t):
    return t.detach().cpu().numpy()


def _t(a):
    return torch.from_numpy(np.asarray(a))


def control_calls(calls: dict, ref_cfg) -> dict:
    """``calls`` (``StageRecorder.calls``) with each output replaced by
    the control's: ``plainref`` on the inputs rounded to bfloat16, K1 on
    the descriptors' high 16 bits of every word."""
    out = {}
    for key, (args, kw, _) in calls.items():
        st = key.split(".")[0]
        if st == "substeps":
            state, cv, cw, oxy, orr, ov, k, _ = _bf16(args)
            r = dynamics.nav_substeps(
                _np(state.xy), _np(state.yaw), _np(state.v), _np(state.w),
                _np(cv), _np(cw), _np(oxy), _np(orr), _np(ov), _np(k),
                ref_cfg.sim)
            new = SimpleNamespace(**{f: _t(r[f]) for f in
                                     ("xy", "yaw", "v", "w")})
            res = (new, (_t(r["path_xy"]), None))
        elif st == "imu":
            state, pos, quat, dt, k, _ = _bf16(args)
            r = imu.imu_block({f: _np(getattr(state, f))
                               for f in state._fields}, _np(pos), _np(quat),
                              float(dt), _np(k), ref_cfg.imu)
            res = (type(state)(*(_t(r[f]) for f in state._fields)),
                   _t(r["meas"]))
        elif st == "k1":
            da, va, db, vb = args
            high = -65536 & 0xFFFFFFFF
            res = hamming.cross_check(da & high, va, db & high, vb,
                                      kw["max_dist"])
        else:
            tc, phi0, n_iter = _bf16(args)
            res = wavefront.relax(tc, phi0, int(n_iter))
        out[key] = (args, kw, res)
    return out


def stage_readings(cell, seed: int, device) -> dict:
    """The stage numbers of the program's first window ticks at the
    cell's size (sound) and of the control in its place."""
    conf, tr = cell.config, cell.traffic
    rows = campaign.sample_rows(seed, len(conf["routes"]) * tr["seeds"],
                                tr["check_rows"])
    s = campaign.set_up(conf, tr, seed, device, rows)
    campaign.window(s, tr["stage_ticks"], tr["repeat_chunk"], device,
                    tr["stage_ticks"])
    calls = s.stages
    del s
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ref_cfg = resolve(conf["reference_preset"])()
    sound = stages.stage_numbers(calls, conf["stages"], ref_cfg)
    ctl = stages.stage_numbers(control_calls(calls, ref_cfg),
                               conf["stages"], ref_cfg)
    return {"sound": sound, "control": ctl}


class _Nudge:
    """A tick hook that moves every row's position by one float32 step
    after tick ``at`` (counted from 0 over the hook's calls)."""

    def __init__(self, at: int):
        self.at, self.calls = at, 0

    def __call__(self, carry):
        self.calls += 1
        if self.calls != self.at + 1:
            return carry
        xy = carry.robot.xy
        return carry._replace(robot=carry.robot._replace(
            xy=torch.nextafter(xy, torch.full_like(xy, float("inf")))))


def _tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def campaign_controls(cell, seeds, n_ticks: int, kinds, device) -> list:
    """For each control in ``kinds`` ("tf32", "bf16", "ulp") and seed:
    the check's numbers with the control's campaign in the program's
    place, and whether the check calls it correct."""
    conf, tr = cell.config, cell.traffic
    routes, n_routes = conf["routes"], len(conf["routes"])
    ref = check.reference_teach(conf, tr, device)
    warm = sum(tr["warm_calls"])
    ctl_teach = {}
    for kind in kinds:
        _tf32(kind == "tf32")
        hook = check_hook(kind, None)
        ctl_teach[kind] = ref if kind == "ulp" else \
            check.reference_teach(conf, tr, device, tick_hook=hook)
        _tf32(False)
    out = []
    for seed in seeds:
        rows = campaign.sample_rows(seed, n_routes * tr["seeds"],
                                    tr["check_rows"]).tolist()
        block = campaign.repeat_seeds(seed, tr["seeds"])
        r_names = tuple(routes[i % n_routes] for i in rows)
        r_seeds = tuple(block[i // n_routes] for i in rows)
        base = check.reference_campaign(ref, r_names, r_seeds,
                                        tr["warm_calls"], n_ticks,
                                        tr["repeat_chunk"])
        for kind in kinds:
            _tf32(kind == "tf32")
            run = check.reference_campaign(
                ctl_teach[kind], r_names, r_seeds, tr["warm_calls"], n_ticks,
                tr["repeat_chunk"], tick_hook=check_hook(kind, warm))
            _tf32(False)
            nums = check.teach_numbers(ctl_teach[kind].teach, ref)
            nums.update(check.state_numbers(run.start, run.carry, base))
            trace = {f: np.asarray(getattr(run.result.trace, f))
                     for f in run.result.trace._fields}
            win, bad = check.window_numbers(trace, base.result.trace)
            nums.update(win)
            nums.update(check.final_numbers(run.result.final, base)[0])
            ok, compared = check.verdict(
                nums, required_numbers(conf) - set(stages.NUMBERS.values()))
            out.append({"control": kind, "seed": seed, "correct": ok,
                        "failed": int(bad.sum()), "check": compared})
    return out


def check_hook(kind: str, warm):
    """The tick hook of a control: the state rounded to bfloat16 after
    every tick, or the one-step nudge at the window's first tick."""
    if kind == "bf16":
        return _bf16
    if kind == "ulp" and warm is not None:
        return _Nudge(warm)
    return None


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--window-ticks", type=int, required=True)
    p.add_argument("--controls", default="stages,tf32,ulp")
    p.add_argument("--out", default="")
    args = p.parse_args()
    cell = find_cell(args.workload)
    seeds = [int(x) for x in args.seeds.split(",")]
    kinds = args.controls.split(",")
    lines = []

    def emit(d):
        d["at_s"] = round(time.perf_counter() - T0, 3)
        print(json.dumps(d), flush=True)
        lines.append(d)

    if "stages" in kinds:
        for seed in seeds:
            emit({"control": "stages", "seed": seed,
                  **stage_readings(cell, seed, "cuda")})
    rest = [k for k in kinds if k != "stages"]
    if rest:
        for d in campaign_controls(cell, seeds, args.window_ticks, rest,
                                   "cuda"):
            emit(d)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(d) + "\n"
                                          for d in lines))
    return 0


T0 = time.perf_counter()

if __name__ == "__main__":
    sys.exit(main())
