#!/usr/bin/env python3
"""Write the JAX reference traces the PyTorch port is held against on a GPU.

The GPU machine has no JAX, so the reference for the port's GT-localized
campaign is recorded here with the JAX package (on the CPU) and committed as
a small npz: two real routes at full width — the 1850x950 map, 192x192
planning window, 80x60 depth rays — for ``--teach-ticks`` GT-localized teach
ticks (``config.gt_localization()`` with ``teach.run_vio=False``) followed by
``--repeat-ticks`` GT repeat ticks, from the campaign runners' default seeds.
``chip_smoke.py`` replays the same campaign on the card and compares.

    JAX_PLATFORMS=cpu python tools/make_torch_fixture.py
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
DEFAULT_OUT = REPO / "tests" / "data" / "torch_gt_campaign_fixture.npz"
ROUTES = ("02_north_forest", "13_cross_nws")


def slice_config(cfg_mod):
    base = cfg_mod.gt_localization()
    return base.replace(teach=dataclasses.replace(base.teach, run_vio=False))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--teach-ticks", type=int, default=100)
    ap.add_argument("--repeat-ticks", type=int, default=100)
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")
    from nclt_slam_tpu import config as cfg_mod
    from nclt_slam_tpu.rollout import campaign

    cfg = slice_config(cfg_mod)
    data = campaign.build_campaign(list(ROUTES), cfg=cfg)
    teach = campaign.run_campaign_teach(data, cfg, args.teach_ticks,
                                        stop_when_done=False)
    wps, n_wps = campaign.teach_waypoints(data, teach, cfg)
    rep = campaign.run_campaign_repeat(data, teach.teach_grid, wps, n_wps,
                                       cfg, args.repeat_ticks,
                                       stop_when_done=False)
    grid = np.asarray(teach.teach_grid)
    occupied = [np.flatnonzero(g == 2).astype(np.int32) for g in grid]
    args.out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        args.out,
        routes=np.asarray(ROUTES),
        teach_gt_xy=np.asarray(teach.trace.gt_xy),
        teach_gt_yaw=np.asarray(teach.trace.gt_yaw),
        teach_done=np.asarray(teach.trace.done),
        teach_free_cells=(grid == 0).sum((1, 2)),
        teach_occupied_idx=np.concatenate(occupied),
        teach_occupied_n=np.asarray([len(o) for o in occupied]),
        store_count=np.asarray(teach.store.count),
        wps=np.asarray(wps), n_wps=np.asarray(n_wps),
        repeat_gt_xy=np.asarray(rep.trace.gt_xy),
        repeat_gt_yaw=np.asarray(rep.trace.gt_yaw),
        repeat_wp_idx=np.asarray(rep.trace.wp_idx),
        repeat_done=np.asarray(rep.trace.done),
        repeat_fired=np.asarray(rep.trace.fired),
        repeat_plan_fails=np.asarray(rep.trace.plan_fails))
    print(f"wrote {args.out} ({args.out.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
