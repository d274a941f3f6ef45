"""Whether the run's output is correct: the program's campaign held to the
plain reference in ``refsim`` (a frozen copy of the port's tick with plain
PyTorch in place of its kernels), and single stages held to ``plainref``
(``pbench/stages.py``).

The reference runs the whole campaign itself, from the raw scene files
and the seeds alone: its own teach over every route, its own waypoints,
teach maps and landmark stores, and then, for the checked rows, its own
initial state, the set-up's warm ticks and the window's ticks.  The
program's artefacts are only compared with it, never fed to it: the
teach (its trace, maps, stores and waypoints), the repeat's initial
state, the state where the window starts, every window tick's trace and
the final state.  The campaign is chaotic (a rounding-level difference
grows into a different run, ``PERF.md`` section 2), so the comparison is
bit for bit where the port's tick is the reference's arithmetic.

Every number compared has its limit in ``LIMITS``; ``PERF.md`` gives the
readings each was set from.  Nothing here imports the port.
"""

from __future__ import annotations

import hashlib
import importlib
import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from pbench.spec import resolve
from pbench.trees import cat_rows, leaves, take_rows

REF = "refsim"

# (number, limit): a number above its limit makes the run incorrect.
LIMITS = {
    "teach_mismatch": 0,        # teach trace, maps, stores and waypoints
    "start_mismatch": 0,        # elements of the repeat's initial state
    "warm_mismatch": 0,         # elements of the state the window starts from
    "gt_gap_m": 1e-3,           # GT position, every checked row and tick
    "nav_gap_m": 1e-3,          # the fused pose fed to navigation
    "vio_gap_m": 1e-3,          # the VIO position
    "cmd_gap": 1e-3,            # the commanded speed [m/s]
    "event_mismatch": 0,        # discrete fields of every checked row-tick
    "state_gap": 1e-3,          # the final state's float leaves, relative
    "state_mismatch": 0,        # the final state's integer and bool leaves
    "substep_gap": 1e-3,        # wheel dynamics [m, rad, m/s] (plainref)
    "imu_gap": 1e-3,            # IMU block [m/s^2, rad/s, ...] (plainref)
    "k1_mismatch": 0,           # kernel K1's matches (plainref)
    "k2_gap": 0,                # kernel K2's potentials, relative (plainref)
}

EVENT_FIELDS = ("regime", "anchor_ok", "anchor_reason", "anchor_inliers",
                "vio_tracked", "vio_ndesc", "vio_nins", "vio_flags",
                "wp_idx", "done", "fired", "goal_blocked", "plan_fails",
                "recovery_phase")


def _mod(name: str):
    return importlib.import_module(f"{REF}.{name}")


def _hooked(module, name: str, tick_hook):
    """Replace ``module.name`` (a tick step returning (carry, trace)) by
    one that applies ``tick_hook(carry)`` after every tick; returns the
    undo."""
    step = getattr(module, name)
    if tick_hook is not None:
        def hooked(carry, *args, **kw):
            carry, tr = step(carry, *args, **kw)
            return tick_hook(carry), tr
        setattr(module, name, hooked)
    return lambda: setattr(module, name, step)


@dataclass
class Teach:
    """A teach over every route of the configuration, as the repeat reads
    it: the trace (numpy), teach maps and landmark stores, a row a route,
    and the waypoints."""
    trace: object
    grid: torch.Tensor
    store: object
    wps: torch.Tensor
    n_wps: torch.Tensor


@dataclass
class RefTeach:
    data: object                # the reference's CampaignData of the routes
    cfg: object                 # the reference's repeat Config
    teach: Teach


def _teach_key(conf: dict, traffic: dict) -> str:
    """What the reference's teach depends on: the configuration, the
    teach's length and chunk, and the reference's own sources."""
    h = hashlib.sha256(json.dumps(
        [conf, traffic["teach_ticks"], traffic["teach_chunk"]],
        sort_keys=True).encode())
    pkg = Path(importlib.import_module(REF).__file__).parent
    for f in sorted(pkg.rglob("*.py")):
        h.update(f.relative_to(pkg).as_posix().encode() + f.read_bytes())
    return h.hexdigest()[:16]


def reference_teach(conf: dict, traffic: dict, device, tick_hook=None,
                    cache_dir: Path | None = None) -> RefTeach:
    """The reference's teach over the configuration's routes, packed from
    the raw scene files, for the traffic's teach ticks.  ``tick_hook(carry)
    -> carry``, when given, is applied after every teach tick (a
    control).  With ``cache_dir``, the teach is computed once and kept
    there, under a name made from what it depends on (``_teach_key``): it
    is the same in every run, and the reference's alone."""
    camp = _mod("rollout.campaign")
    cfg = resolve(conf["reference_preset"])()
    teach_cfg = resolve(conf["reference_teach_preset"])()
    data = camp.build_campaign(conf["routes"], seed=conf["scene_seed"],
                               cfg=teach_cfg, device=device)
    path = None
    if cache_dir is not None and tick_hook is None:
        path = Path(cache_dir) / f"teach-{_teach_key(conf, traffic)}.pt"
        if path.exists():
            kept = torch.load(path, weights_only=False)
            return RefTeach(data=data, cfg=cfg, teach=Teach(
                trace=kept.trace, grid=kept.grid.to(device),
                store=type(kept.store)(*(x.to(device) for x in kept.store)),
                wps=kept.wps.to(device), n_wps=kept.n_wps.to(device)))
    undo = _hooked(_mod("rollout.teach"), "teach_step", tick_hook)
    try:
        res = camp.run_campaign_teach(data, teach_cfg, traffic["teach_ticks"],
                                      chunk=traffic["teach_chunk"])
    finally:
        undo()
    wps, n_wps = camp.teach_waypoints(data, res, teach_cfg)
    trace = type(res.trace)(*(np.asarray(x) for x in res.trace))
    teach = Teach(trace=trace, grid=res.teach_grid, store=res.store,
                  wps=wps, n_wps=n_wps)
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        torch.save(Teach(trace=trace, grid=teach.grid.cpu(),
                         store=type(res.store)(*(x.cpu() for x in res.store)),
                         wps=wps.cpu(), n_wps=n_wps.cpu()), tmp)
        tmp.replace(path)
    return RefTeach(data=data, cfg=cfg, teach=teach)


@dataclass
class RefRun:
    start: object               # the repeat's initial state
    carry: object               # the state where the window starts
    result: object              # the window's RepeatResult


def reference_campaign(ref: RefTeach, routes: tuple, seeds: tuple,
                       warm_calls, n_ticks: int, chunk: int,
                       tick_hook=None) -> RefRun:
    """The reference's repeat of the checked rows (``routes[i]`` at repeat
    seed ``seeds[i]``) off its own teach: its initial state, the set-up's
    warm calls and the window's call.  ``tick_hook`` as in
    ``reference_teach``, after every repeat tick."""
    camp = _mod("rollout.campaign")
    repeat = _mod("rollout.repeat")
    names = tuple(ref.data.names)
    idx = torch.tensor([names.index(r) for r in routes])
    d, t = ref.data, ref.teach
    rows = camp.CampaignData(
        scenes_teach=take_rows(d.scenes_teach, idx),
        scenes_repeat=take_rows(d.scenes_repeat, idx),
        routes=take_rows(d.routes, idx), names=routes)
    grid, wps, n_wps = (take_rows(x, idx) for x in (t.grid, t.wps, t.n_wps))
    stores = take_rows(t.store, idx)
    run_wps, run_n = camp.apply_stock_projection(grid, wps, n_wps, ref.cfg)
    one = torch.arange(1)
    start = cat_rows([
        repeat.init_repeat_carry(take_rows(rows.routes, one + i),
                                 run_wps[i:i + 1], run_n[i:i + 1], ref.cfg,
                                 seed=s)
        for i, s in enumerate(seeds)])
    undo = _hooked(repeat, "repeat_step", tick_hook)
    try:
        carry, tick = take_rows(start, torch.arange(len(seeds))), 0
        for n in warm_calls:
            carry = camp.run_campaign_repeat(
                rows, grid, wps, n_wps, ref.cfg, n, stores=stores,
                carry=carry, tick0=tick, chunk=chunk,
                stop_when_done=False).final
            tick += n
        warm = take_rows(carry, torch.arange(len(seeds)))
        res = camp.run_campaign_repeat(
            rows, grid, wps, n_wps, ref.cfg, n_ticks, stores=stores,
            carry=carry, tick0=tick, chunk=chunk, stop_when_done=False)
    finally:
        undo()
    return RefRun(start=start, carry=warm, result=res)


def _gap_xy(a, b) -> float:
    if np.asarray(a).size == 0:
        return 0.0
    d = np.hypot(*(np.asarray(a, np.float64)
                   - np.asarray(b, np.float64)).reshape(-1, 2).T)
    return float(np.nan_to_num(d, nan=np.inf).max())


def _mismatch(a, b) -> np.ndarray:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return np.ones(max(a.size, b.size, 1), bool)
    same = (a == b)
    if a.dtype.kind == "f":
        same |= np.isnan(a) & np.isnan(b)
    return ~same


def differing(prog, ref) -> int:
    """Elements that differ between two trees of tensors or arrays (NaN
    equals NaN): an exact comparison."""
    if isinstance(prog, (torch.Tensor, np.ndarray)):
        as_np = lambda x: x.cpu().numpy() if isinstance(  # noqa: E731
            x, torch.Tensor) else x
        return int(_mismatch(as_np(prog), as_np(ref)).sum())
    return sum(differing(a, b) for a, b in zip(prog, ref))


def leaf_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest difference of two float tensors over the reference's
    largest magnitude (1 where that is under 1); equal elements, infinite
    ones included, count 0."""
    a, b = a.double().cpu(), b.double().cpu()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    d = torch.where(same, torch.zeros_like(a), (a - b).abs())
    d = torch.nan_to_num(d, nan=float("inf"))
    finite = b[torch.isfinite(b)]
    scale = max(1.0, float(finite.abs().max())) if finite.numel() else 1.0
    return float(d.max()) / scale if d.numel() else 0.0


def compare_trees(prog, ref) -> tuple[float, int, str]:
    """(largest relative gap over float leaves, mismatching elements of
    the other leaves, the leaf with the largest gap or first mismatch)."""
    worst, n_bad, where = 0.0, 0, ""
    for (name, a), (_, b) in zip(leaves(prog), leaves(ref)):
        if a.is_floating_point():
            g = leaf_gap(a, b)
            if g > worst:
                worst, where = g, name
        else:
            bad = int((a.cpu() != b.cpu()).sum())
            if bad and not n_bad and not where:
                where = name
            n_bad += bad
    return worst, n_bad, where


def teach_numbers(prog: Teach, ref: RefTeach) -> dict:
    """The program's teach against the reference's, element by element:
    every field of the trace, the teach maps, the landmark stores and the
    waypoints."""
    r = ref.teach
    n = sum(int(_mismatch(getattr(prog.trace, f), getattr(r.trace, f)).sum())
            for f in r.trace._fields)
    n += differing(prog.grid, r.grid) + differing(prog.store, r.store)
    n += differing(prog.wps, r.wps) + differing(prog.n_wps, r.n_wps)
    return {"teach_mismatch": n}


def state_numbers(prog_start, prog_carry, ref: RefRun) -> dict:
    return {"start_mismatch": differing(prog_start, ref.start),
            "warm_mismatch": differing(prog_carry, ref.carry)}


def window_numbers(prog_trace: dict, ref_trace) -> tuple[dict, np.ndarray]:
    """The window's numbers and each checked row-tick's failure flag
    (B, T).  ``prog_trace`` maps a trace field to the program's (B, T, ...)
    array at the checked rows."""
    nums = {
        "gt_gap_m": _gap_xy(prog_trace["gt_xy"], ref_trace.gt_xy),
        "nav_gap_m": _gap_xy(prog_trace["nav_xy"], ref_trace.nav_xy),
        "vio_gap_m": _gap_xy(prog_trace["vio_xy"], ref_trace.vio_xy),
        "cmd_gap": float(np.abs(np.asarray(prog_trace["cmd_v"], np.float64)
                                - ref_trace.cmd_v).max(initial=0.0)),
    }
    bad = np.zeros(ref_trace.done.shape, bool)
    n_events = 0
    for f in EVENT_FIELDS:
        m = _mismatch(prog_trace[f], getattr(ref_trace, f))
        n_events += int(m.sum())
        bad |= m.reshape(m.shape[0], m.shape[1], -1).any(-1)
    nums["event_mismatch"] = n_events
    for f, lim in (("gt_xy", "gt_gap_m"), ("nav_xy", "nav_gap_m"),
                   ("vio_xy", "vio_gap_m")):
        d = np.hypot(*np.moveaxis(np.asarray(prog_trace[f], np.float64)
                                  - getattr(ref_trace, f), -1, 0))
        bad |= np.nan_to_num(d, nan=np.inf) > LIMITS[lim]
    bad |= np.abs(np.asarray(prog_trace["cmd_v"], np.float64)
                  - ref_trace.cmd_v) > LIMITS["cmd_gap"]
    return nums, bad


def final_numbers(prog_final, ref: RefRun) -> tuple[dict, str]:
    gap, n_bad, where = compare_trees(prog_final, ref.result.final)
    return {"state_gap": gap, "state_mismatch": n_bad}, where


def verdict(nums: dict, required=None) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over every number; each of
    ``required`` (default every limit's name) has to be there."""
    required = set(LIMITS if required is None else required)
    out = {k: {"value": nums[k], "limit": LIMITS[k]} for k in LIMITS
           if k in nums}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in out.values()) and required <= set(out)
    return ok, out
