#!/usr/bin/env python3
"""Where do two devices first observe the features in a different order?

``observe`` keeps the 256 nearest visible features sorted by their float32
distance and draws pixel, depth and descriptor noise per row.  Two features
at one distance to the last bit can swap rows between a CUDA card and the
CPU; their map points then take each other's noise draw, and the VIO maps of
the two devices differ in those points by far more than rounding (the
running mean shrinks the difference again), whatever refines the map.

Record the feature ids of every repeat tick of the ``rgbd_ba`` fixture
campaign (the two routes and tick counts of ``tools/make_torch_fixture.py``)
on each device, then compare the two recordings:

    python3 tools/torch_observe_order_probe.py record cpu cpu.npz
    python3 tools/torch_observe_order_probe.py record cuda cuda.npz
    python3 tools/torch_observe_order_probe.py compare cpu.npz cuda.npz
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
ROUTES = ["06_nw_ne", "09_se_ne"]
TEACH_TICKS = 150
REPEAT_TICKS = 90


def record(device: str, out: str):
    sys.path.insert(0, str(REPO))
    import torch

    from nclt_slam_tpu_torch import config
    from nclt_slam_tpu_torch.baselines import configs as baselines
    from nclt_slam_tpu_torch.rollout import campaign
    from nclt_slam_tpu_torch.rollout import repeat as repeat_mod

    if device == "cpu":
        torch.set_num_threads(4)
    teach_cfg = config.gt_localization()
    data = campaign.build_campaign(ROUTES, cfg=teach_cfg, device=device)
    teach = campaign.run_campaign_teach(data, teach_cfg, TEACH_TICKS,
                                        stop_when_done=False)
    wps, n_wps = campaign.teach_waypoints(data, teach, config.ours())
    rec = dict(feat_id=[], valid=[])
    inner = repeat_mod.observe

    def watched(*args, **kwargs):
        obs = inner(*args, **kwargs)
        rec["feat_id"].append(obs.feat_id.cpu().numpy())
        rec["valid"].append(obs.valid.cpu().numpy())
        return obs

    repeat_mod.observe = watched
    try:
        rep = campaign.run_campaign_repeat(
            data, teach.teach_grid, wps, n_wps, baselines.rgbd_ba(),
            REPEAT_TICKS, stores=teach.store, stop_when_done=False)
    finally:
        repeat_mod.observe = inner
    np.savez_compressed(out, map_xyz=rep.final.vio.map_xyz.cpu().numpy(),
                        **{k: np.stack(v) for k, v in rec.items()})
    print(f"recorded {len(rec['feat_id'])} ticks on {device} into {out}")


def compare(path_a: str, path_b: str):
    a, b = np.load(path_a), np.load(path_b)
    n_ticks = min(len(a["feat_id"]), len(b["feat_id"]))
    for t in range(n_ticks):
        for r in range(a["feat_id"].shape[1]):
            fa, fb = a["feat_id"][t, r], b["feat_id"][t, r]
            va, vb = a["valid"][t, r], b["valid"][t, r]
            rows = np.flatnonzero((fa != fb) | (va != vb))
            if len(rows):
                print(f"tick {t} route {r}: rows {rows.tolist()} hold "
                      f"features {fa[rows].tolist()} against "
                      f"{fb[rows].tolist()}; the same set of features: "
                      f"{set(fa[va]) == set(fb[vb])}")
    print(f"largest map point difference after {n_ticks} ticks: "
          f"{np.abs(a['map_xyz'] - b['map_xyz']).max()} m")


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "record":
        record(sys.argv[2], sys.argv[3])
    elif len(sys.argv) == 4 and sys.argv[1] == "compare":
        compare(sys.argv[2], sys.argv[3])
    else:
        sys.exit(__doc__)
