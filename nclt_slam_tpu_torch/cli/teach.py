"""Teach-pass CLI — the run_teach.sh equivalent (``nclt_slam_tpu/cli/teach.py``).

    python -m nclt_slam_tpu_torch.cli.teach --route 03_south --out /tmp/tr/03_south/teach

Runs one route as a batch of 1 (GT relay config, as the reference's
--use-gt teach) on the CUDA card, or on ``--device cpu``, and writes the
reference artefact set: teach_map.{pgm,yaml}, landmarks.pkl,
vio_pose_dense.csv, traj_gt.csv.
"""

from __future__ import annotations

import argparse

from nclt_slam_tpu_torch.cli.common import (
    add_device_arg,
    batch1,
    config_for,
    write_teach_artifacts,
)
from nclt_slam_tpu_torch.rollout.campaign import campaign_device
from nclt_slam_tpu_torch.rollout.scene_pack import pack_route, pack_scene
from nclt_slam_tpu_torch.rollout.teach import run_teach
from nclt_slam_tpu_torch.scene import default_scene, get_route


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--route", default="03_south")
    ap.add_argument("--out", required=True)
    ap.add_argument("--ticks", type=int, default=9000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="sensor resolution scale (CPU debugging)")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    dev = campaign_device(args.device)
    cfg = config_for("gt", args.scale)  # teach runs with GT relay (--use-gt)
    route = get_route(args.route)
    scene = batch1(pack_scene(default_scene(), device=dev))
    packed = batch1(pack_route(route, cfg, dev))

    print(f"[teach] {args.route}: {route.n_dense} dense WPs, "
          f"{args.ticks} ticks max")
    res = run_teach(scene, packed, cfg, args.ticks, seed=args.seed)
    n = int(res.n_ticks[0])
    print(f"[teach] ROUTE COMPLETE in {n} ticks, "
          f"{int(res.store.count[0])} landmarks")
    out = write_teach_artifacts(args.out, res, route, cfg)
    print(f"[teach] artefacts -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
