"""The port's campaign as a user runs it: one teach over the routes, then
the repeat over routes x seeds as batch rows off that teach.

``set_up`` does everything before the window (the campaign build, the
teach, the seed batch, the warm ticks) and ``window`` makes the one timed
call of ``run_campaign_repeat``.  Every name of the port is imported
inside the functions, so that importing this module loads nothing of it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from pbench.check import Teach
from pbench.spec import resolve
from pbench.stages import StageRecorder
from pbench.trees import cat_rows, take_rows, to_cpu

PORT = "nclt_slam_tpu_torch"


def repeat_seeds(seed: int, per_block: int) -> tuple[int, ...]:
    """The repeat seeds of ``--seed n``: ``k n - k + 1 ... k n`` for ``k``
    seeds a run, reduced to the 32 bits the port's PRNG key holds."""
    return tuple((per_block * seed - per_block + 1 + i) % 2 ** 32
                 for i in range(per_block))


def window_ticks(seconds: float, s_per_tick: float, period: int,
                 s_per_call: float = 0.0) -> int:
    """The window's tick count: the multiple of ``period`` nearest to
    ``(seconds - s_per_call) / s_per_tick``, at least one period."""
    n = (seconds - s_per_call) / s_per_tick
    return max(period, int(round(n / period)) * period)


def env_steps_per_s(rows: int, substeps: int, ticks: int,
                    wall_s: float) -> float:
    """Environment steps a second: rows x substeps x executed ticks over
    the wall seconds they took."""
    return rows * substeps * ticks / wall_s


def check_widths(cfg, widths: dict) -> None:
    """Raise unless every ``"section.key": value`` of the configuration
    file holds in the preset that runs."""
    for path, want in widths.items():
        obj = cfg
        for part in path.split("."):
            obj = getattr(obj, part)
        if obj != want:
            raise ValueError(f"the preset runs {path} = {obj!r}; the "
                             f"configuration file states {want!r}")


class CallTimer:
    """Host seconds spent in ``module.name`` while installed (the once a
    call work of ``run_campaign_repeat``, which the window's tick count
    leaves out of its seconds a tick)."""

    def __init__(self, module, name: str):
        self.module, self.name, self.seconds = module, name, 0.0

    def __enter__(self):
        fn = self.fn = getattr(self.module, self.name)

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.seconds += time.perf_counter() - t0

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)
        return False


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@dataclass
class SetUp:
    cfg: object                 # the port's Config of the repeat
    data: object                # the 15-route CampaignData
    big: object                 # the seed batch's CampaignData
    grid: torch.Tensor          # teach maps, a row each
    wps: torch.Tensor
    n_wps: torch.Tensor
    stores: object
    carry: object               # the carry after the warm ticks
    teach: object               # the teach's artefacts (check.Teach), host
    stages: dict                # StageRecorder.calls of the window
    teach_s: float
    teach_ticks: int            # executed teach ticks
    warm_ticks: int
    warm_s_per_tick: float      # the last warm call's seconds a tick
    warm_s_per_call: float      # its once-a-call host work (stock projection)
    seeds: tuple
    sample: "Sample"            # what the reference reads of the rows it checks


def set_up(conf: dict, traffic: dict, seed: int, device,
           rows: torch.Tensor) -> SetUp:
    """Build, teach, tile and warm, as set-up; the returned carry is the
    state the window starts from.  ``rows`` are the batch rows the
    reference will check: their state is copied before the warm ticks and
    before the window, which may update tensors in place.  The teach's
    artefacts are copied to the host."""
    import importlib

    camp = importlib.import_module(f"{PORT}.rollout.campaign")
    rep = importlib.import_module(f"{PORT}.rollout.repeat")

    cfg = resolve(conf["preset"])()
    teach_cfg = resolve(conf["teach_preset"])()
    check_widths(cfg, conf["widths"])
    check_widths(teach_cfg, conf["widths"])
    data = camp.build_campaign(conf["routes"], seed=conf["scene_seed"],
                               cfg=teach_cfg, device=device)
    n_feat = data.scenes_teach.feat_xyz.shape[1]
    if n_feat != conf["scene_features_per_route"]:
        raise ValueError(f"packed scenes hold {n_feat} features a route; "
                         f"the configuration states "
                         f"{conf['scene_features_per_route']}")

    sync(device)
    t0 = time.perf_counter()
    teach = camp.run_campaign_teach(data, teach_cfg, traffic["teach_ticks"],
                                    chunk=traffic["teach_chunk"])
    teach_s = time.perf_counter() - t0   # ends in the traces' host copy
    n_chunks, chunk = camp.planned_chunks(traffic["teach_ticks"],
                                          traffic["teach_chunk"])
    wps, n_wps = camp.teach_waypoints(data, teach, teach_cfg)

    seeds = repeat_seeds(seed, traffic["seeds"])
    big, grid, wps_k, n_k, stores, _ = camp.expand_for_ablations(
        data, teach.teach_grid, wps, n_wps, teach.store,
        ablations=("drops",) * len(seeds))
    prog_teach = Teach(trace=to_cpu(teach.trace), grid=teach.teach_grid.cpu(),
                       store=to_cpu(teach.store), wps=wps.cpu(),
                       n_wps=n_wps.cpu())
    run_wps, run_n = camp.apply_stock_projection(teach.teach_grid, wps,
                                                 n_wps, cfg)
    carry = cat_rows([rep.init_repeat_carry(data.routes, run_wps, run_n, cfg,
                                            seed=s) for s in seeds])
    n_routes = len(data.names)
    sample = Sample(
        rows=rows, routes=tuple(data.names[i % n_routes]
                                for i in rows.tolist()),
        seeds=tuple(seeds[i // n_routes] for i in rows.tolist()),
        start_carry=take_rows(carry, rows), carry=None, tick0=0)
    del teach
    tick, s_per_tick, per_call = 0, None, 0.0
    for n in traffic["warm_calls"]:
        sync(device)
        with CallTimer(camp, "apply_stock_projection") as once:
            t0 = time.perf_counter()
            res = camp.run_campaign_repeat(
                big, grid, wps_k, n_k, cfg, n, stores=stores, carry=carry,
                tick0=tick, chunk=traffic["repeat_chunk"],
                stop_when_done=False)
            wall = time.perf_counter() - t0
        per_call = once.seconds
        s_per_tick = (wall - per_call) / n
        carry, tick = res.final, tick + n
    sample.carry, sample.tick0 = take_rows(carry, rows), tick
    return SetUp(cfg=cfg, data=data, big=big, grid=grid,
                 wps=wps_k, n_wps=n_k, stores=stores, carry=carry,
                 teach=prog_teach, stages={},
                 teach_s=teach_s, teach_ticks=n_chunks * chunk,
                 warm_ticks=tick, warm_s_per_tick=s_per_tick,
                 warm_s_per_call=per_call, seeds=seeds,
                 sample=sample)


def window(s: SetUp, n_ticks: int, chunk: int, device,
           stage_ticks: int = 0):
    """The timed call: ``n_ticks`` repeat ticks from the warm carry, in one
    ``run_campaign_repeat`` call that ends in the traces' copy to the host.
    The stages of its first ``stage_ticks`` ticks are recorded into
    ``s.stages``.  Returns (RepeatResult, wall seconds, executed ticks)."""
    import importlib

    camp = importlib.import_module(f"{PORT}.rollout.campaign")
    ticks = range(s.warm_ticks, s.warm_ticks + stage_ticks)
    sync(device)
    with StageRecorder(ticks) as rec:
        t0 = time.perf_counter()
        res = camp.run_campaign_repeat(
            s.big, s.grid, s.wps, s.n_wps, s.cfg, n_ticks, stores=s.stores,
            carry=s.carry, tick0=s.warm_ticks, chunk=chunk,
            stop_when_done=False)
        wall = time.perf_counter() - t0
    s.stages = rec.calls
    n_chunks, per = camp.planned_chunks(n_ticks, chunk)
    return res, wall, n_chunks * per


def sample_rows(seed: int, n_rows: int, n_sample: int) -> torch.Tensor:
    """The rows the reference checks, drawn from the seed (sorted)."""
    rng = np.random.default_rng(seed)
    k = min(n_sample, n_rows)
    return torch.from_numpy(np.sort(rng.choice(n_rows, k, replace=False)))


@dataclass
class Sample:
    """The checked rows, and the program's state there before the warm
    ticks and where the window starts (compared with the reference's)."""
    rows: torch.Tensor
    routes: tuple               # route name of each checked row
    seeds: tuple                # repeat seed of each checked row
    start_carry: object         # the repeat's initial carry
    carry: object               # the carry the window starts from
    tick0: int
