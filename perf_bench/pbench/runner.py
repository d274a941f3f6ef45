"""One run of one cell: set-up, the window (timed, or traced), the check
against the reference, and the result line."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from pbench import campaign, check, stages
from pbench.spec import Cell, metric_reader
from pbench.trace import ShapeRecorder, profile_call
from pbench.trees import take_rows

FORBIDDEN = ("jax", "jaxlib", "flax", "nclt_slam_tpu")


def log(msg: str) -> None:
    print(f"[perf_bench] {msg}", file=sys.stderr, flush=True)


def process_start_s() -> float:
    """``time.perf_counter()`` at this process's start (Linux: its start
    time in /proc; elsewhere the first call of this function)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        import os
        return now - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared as whole names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def nvidia_smi(query: list[str]) -> str:
    try:
        out = subprocess.run(["nvidia-smi", *query], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"


def card_lines() -> tuple[str, str]:
    card = nvidia_smi(["--query-gpu=name,clocks.sm,clocks.max.sm,"
                       "power.draw,power.limit,temperature.gpu",
                       "--format=csv,noheader"])
    apps = nvidia_smi(["--query-compute-apps=pid,process_name,used_memory",
                       "--format=csv,noheader"])
    return card, apps


def _trace_rows(trace, rows: torch.Tensor) -> dict:
    idx = rows.numpy()
    return {f: np.asarray(getattr(trace, f))[idx] for f in trace._fields}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """The result of one run (the dict printed as the last line)."""
    conf, tr = cell.config, cell.traffic
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    n_rows = len(conf["routes"]) * tr["seeds"]
    rows = campaign.sample_rows(seed, n_rows, tr["check_rows"])
    s = campaign.set_up(conf, tr, seed, device, rows)
    substeps = s.cfg.sim.nav_decimation
    ctx = {"teach_s": s.teach_s, "teach_ticks": s.teach_ticks}
    dtrace = None

    if trace:
        n_ticks = tr["trace_ticks"]
    else:
        n_ticks = campaign.window_ticks(seconds, s.warm_s_per_tick,
                                        tr["cadence_ticks"],
                                        s.warm_s_per_call)
    t_window = time.perf_counter()
    if trace and on_card:
        with ShapeRecorder() as rec:
            (res, wall, executed), dtrace = profile_call(
                lambda: campaign.window(s, n_ticks, tr["repeat_chunk"],
                                        device, tr["stage_ticks"]))
        dtrace.shapes = {"k1": rec.k1, "k2": rec.k2}
    else:
        res, wall, executed = campaign.window(s, n_ticks, tr["repeat_chunk"],
                                              device, tr["stage_ticks"])
    setup_s = t_window - t_start
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package loaded: "
                           f"{found}")

    prog_trace = _trace_rows(res.trace, rows)
    prog_final = take_rows(res.final, rows)
    live = float(1.0 - np.asarray(res.trace.done)[:, -1].mean())
    card, apps = card_lines() if on_card else ("cpu", "")
    log(f"window: {executed} executed ticks from tick {s.warm_ticks} over "
        f"{n_rows} rows, {wall:.4f} s; warm {s.warm_s_per_tick * 1e3:.2f} "
        f"ms a tick and {s.warm_s_per_call:.3f} s a call; teach "
        f"{s.teach_ticks} ticks {s.teach_s:.3f} s")
    log(f"rows still short of their last waypoint at the window's end: "
        f"{live * 100:.2f} %")
    log(f"peak device memory: {peak} bytes")
    log(f"card: {card}")
    log(f"processes on the card: {apps or 'none listed'}")
    if dtrace is not None:
        log(f"traced: {len(dtrace.kernels)} kernels, "
            f"{dtrace.runtime_launches} launch calls, busy "
            f"{dtrace.busy_s():.6f} s of {dtrace.window_s:.6f} s")

    # the program's state is freed before the references run
    del s.big, s.grid, s.wps, s.n_wps, s.stores, s.carry, s.data, res
    if on_card:
        torch.cuda.empty_cache()
    nums, where, t_check = check_run(cell, s, prog_trace, prog_final,
                                     n_ticks, device)
    ok, compared = check.verdict(nums, required_numbers(conf))
    bad = nums.pop("_bad")
    log(f"check: {len(rows)} rows x {n_ticks} ticks and the teach against "
        f"the reference in {time.perf_counter() - t_check:.3f} s"
        + (f"; first differing state leaf {where}" if where else ""))

    if trace:
        ctx.update(trace=dtrace, traced_ticks=executed)
        metrics = {}
        for m in cell.per_layer:
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"env_steps_per_s": campaign.env_steps_per_s(
                      n_rows, substeps, executed, wall),
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if on_card
                   else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": ok, "attempted": n_rows * executed,
           "failed": int(bad.sum()), "metrics": metrics,
           "device": device_info}
    if dtrace is not None:
        device_info.update(busy_s=dtrace.busy_s(), window_s=dtrace.window_s)
        out["breakdown"] = {"device_ops": dtrace.top_ops(),
                            "idle_gaps": dtrace.idle_gaps()}
    out["check"] = compared
    return out


def required_numbers(conf: dict) -> set:
    """The numbers a run of this configuration has to report: the
    campaign's, and those of the stages the configuration runs."""
    skipped = {stages.NUMBERS[st] for st in stages.STAGES
               if st not in conf["stages"]}
    return set(check.LIMITS) - skipped


def check_run(cell: Cell, s, prog_trace: dict, prog_final, n_ticks: int,
              device):
    """The checked numbers (with ``_bad``, each checked row-tick's failure
    flag), the first differing state leaf and the check's start time.
    The program's teach, states and traces are compared with the
    reference's own run of the same ``n_ticks`` window ticks, and its
    recorded stages with ``plainref``."""
    conf, tr = cell.config, cell.traffic
    t_check = time.perf_counter()
    ref = check.reference_teach(conf, tr, device,
                                cache_dir=cell.root / "build" / "perf_bench")
    nums = stages.stage_numbers(s.stages, conf["stages"], ref.cfg)
    s.stages.clear()
    nums.update(check.teach_numbers(s.teach, ref))
    run = check.reference_campaign(ref, s.sample.routes, s.sample.seeds,
                                   tr["warm_calls"], n_ticks,
                                   tr["repeat_chunk"])
    nums.update(check.state_numbers(s.sample.start_carry, s.sample.carry,
                                    run))
    win, bad = check.window_numbers(prog_trace, run.result.trace)
    nums.update(win)
    fin, where = check.final_numbers(prog_final, run)
    nums.update(fin, _bad=bad)
    return nums, where, t_check


def report(out: dict) -> None:
    """The check's numbers as the last lines of standard error, then the
    result as the last line of standard output."""
    for name, v in out["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
