#!/usr/bin/env python3
"""Write the JAX reference traces the PyTorch port is held against on a GPU.

The GPU machine has no JAX, so the references for the port's campaigns are
recorded here with the JAX package (on the CPU) and committed as small
npz files, each of two real routes at full width — the 1850x950 map, 192x192
planning window, 80x60 depth rays, 256 live features — from the campaign
runners' default seeds:

- ``torch_gt_campaign_fixture.npz``: ``--teach-ticks`` GT-localized teach
  ticks (``config.gt_localization()`` with ``teach.run_vio=False``), then
  ``--repeat-ticks`` GT repeat ticks;
- ``torch_ours_campaign_fixture.npz``: ``OURS_TEACH_TICKS`` teach ticks
  with the live VIO (the ``gt_localization()`` default), waypoints from the
  aligned VIO track, then ``OURS_REPEAT_TICKS`` full-stack repeat ticks
  (``config.ours()``: VIO + anchors + v55 fusion).

``chip_smoke.py`` replays the same campaigns on the card and compares.
The tool writes both files:

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
DATA = REPO / "tests" / "data"
GT_OUT = DATA / "torch_gt_campaign_fixture.npz"
OURS_OUT = DATA / "torch_ours_campaign_fixture.npz"
ROUTES = ("02_north_forest", "13_cross_nws")
# two routes whose first landmark block survives the repeat session's
# appearance death (LandmarkConfig.session_dead_frac), so that anchors
# publish inside the window
OURS_ROUTES = ("06_nw_ne", "09_se_ne")
# long enough for the relay to commit, the robots to leave the startup hold
# and anchors to publish inside the repeat window
OURS_TEACH_TICKS = 150
OURS_REPEAT_TICKS = 150


def slice_config(cfg_mod):
    base = cfg_mod.gt_localization()
    return base.replace(teach=dataclasses.replace(base.teach, run_vio=False))


def write_gt(cfg_mod, campaign, teach_ticks, repeat_ticks, out: Path):
    cfg = slice_config(cfg_mod)
    data = campaign.build_campaign(list(ROUTES), cfg=cfg)
    teach = campaign.run_campaign_teach(data, cfg, teach_ticks,
                                        stop_when_done=False)
    wps, n_wps = campaign.teach_waypoints(data, teach, cfg)
    rep = campaign.run_campaign_repeat(data, teach.teach_grid, wps, n_wps,
                                       cfg, repeat_ticks,
                                       stop_when_done=False)
    grid = np.asarray(teach.teach_grid)
    occupied = [np.flatnonzero(g == 2).astype(np.int32) for g in grid]
    np.savez_compressed(
        out,
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


def write_ours(cfg_mod, campaign, teach_ticks, repeat_ticks, out: Path):
    teach_cfg = cfg_mod.gt_localization()        # teach.run_vio=True
    cfg = cfg_mod.ours()
    data = campaign.build_campaign(list(OURS_ROUTES), cfg=teach_cfg)
    teach = campaign.run_campaign_teach(data, teach_cfg, teach_ticks,
                                        stop_when_done=False)
    wps, n_wps = campaign.teach_waypoints(data, teach, cfg)   # source="vio"
    rep = campaign.run_campaign_repeat(data, teach.teach_grid, wps, n_wps,
                                       cfg, repeat_ticks, stores=teach.store,
                                       stop_when_done=False)
    t, r = teach.trace, rep.trace
    np.savez_compressed(
        out,
        routes=np.asarray(OURS_ROUTES),
        teach_gt_xy=np.asarray(t.gt_xy), teach_vio_xy=np.asarray(t.vio_xy),
        teach_done=np.asarray(t.done),
        teach_vio_tracked=np.asarray(t.vio_tracked),
        store_count=np.asarray(teach.store.count),
        wps=np.asarray(wps), n_wps=np.asarray(n_wps),
        repeat_gt_xy=np.asarray(r.gt_xy), repeat_nav_xy=np.asarray(r.nav_xy),
        repeat_regime=np.asarray(r.regime),
        repeat_anchor_ok=np.asarray(r.anchor_ok),
        repeat_anchor_reason=np.asarray(r.anchor_reason),
        repeat_anchor_inliers=np.asarray(r.anchor_inliers),
        repeat_vio_tracked=np.asarray(r.vio_tracked),
        repeat_wp_idx=np.asarray(r.wp_idx), repeat_done=np.asarray(r.done),
        repeat_committed=np.asarray(rep.final.fusion.committed))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--teach-ticks", type=int, default=100)
    ap.add_argument("--repeat-ticks", type=int, default=100)
    args = ap.parse_args(argv)

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")
    from nclt_slam_tpu import config as cfg_mod
    from nclt_slam_tpu.rollout import campaign

    DATA.mkdir(parents=True, exist_ok=True)
    write_gt(cfg_mod, campaign, args.teach_ticks, args.repeat_ticks, GT_OUT)
    print(f"wrote {GT_OUT} ({GT_OUT.stat().st_size} bytes)")
    write_ours(cfg_mod, campaign, OURS_TEACH_TICKS, OURS_REPEAT_TICKS,
               OURS_OUT)
    print(f"wrote {OURS_OUT} ({OURS_OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
