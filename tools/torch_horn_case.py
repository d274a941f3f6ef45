#!/usr/bin/env python3
"""The anchor matcher's RANSAC hypotheses at a replayed matcher case, and
the CPU's Horn solve of them, as a fixture for the card.

A case file (``tests/data/torch_matcher_{case,tie_case}.npz``, cut by
``tools/torch_divergence_probe.py --case-out``) holds ``match_tick``'s
inputs at one route and tick.  ``case_inputs`` loads them into the port as a
batch of one; ``ransac_inputs`` runs ``match_tick`` on them and keeps what
it hands ``ransac_pose`` (every candidate: teach points, live pixels, live
points, matched pairs, keys); ``hypotheses`` draws RANSAC's 3-point samples
from those (``matcher.ransac_samples``).

``main`` writes ``tests/data/torch_horn_tie_case.npz``: the tie case's
hypotheses (P, Q (C, H, 3, 3), w) and ``_horn_starts`` of them on the CPU
in float32 (V, rayleigh, mp, mq).  ``chip_smoke.py`` (11i) solves the same
hypotheses on the card and compares the bits; the CPU tests hold the file
to the code.  Imports no JAX.

    python3 tools/torch_horn_case.py [--case PATH] [--out PATH]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

DATA = REPO / "tests" / "data"
TIE_CASE = DATA / "torch_matcher_tie_case.npz"
FIXTURE = DATA / "torch_horn_tie_case.npz"


def case_inputs(path):
    """``match_tick``'s inputs at a case, a batch of one on the CPU:
    (store, obs, vio_xy, vio_heading, base_pos_vio, key, extra)."""
    from nclt_slam_tpu_torch import interop
    from nclt_slam_tpu_torch.landmarks.store import LandmarkStore
    from nclt_slam_tpu_torch.sensors.features import Observation

    with np.load(path) as z:
        c = {k: np.asarray(v)[None] for k, v in z.items()}
    store = LandmarkStore(*(c[f"store_{f}"] for f in LandmarkStore._fields))
    obs = Observation(*(c[f"obs_{f}"] for f in Observation._fields))
    return interop.from_numpy_tree(
        (store, obs, c["xy"], c["yaw"], c["query"], c["key"], c["extra"]),
        "cpu")


def case_config():
    """The rgbd mode's camera and landmark settings, which the cases were
    cut from."""
    from nclt_slam_tpu_torch.baselines import configs

    cfg = configs.rgbd_no_imu()
    return cfg.camera, cfg.landmarks


def ransac_inputs(path):
    """What ``match_tick`` hands ``ransac_pose`` at a case: (p3d_teach,
    uv_live, p3d_live, pair_valid, keys), each (1, C, ...)."""
    from nclt_slam_tpu_torch.landmarks import matcher

    cam, lcfg = case_config()
    store, obs, xy, yaw, query, key, extra = case_inputs(path)
    seen = []
    real = matcher.ransac_pose

    def keep(*args):
        seen.append(args[:5])
        return real(*args)

    matcher.ransac_pose = keep
    try:
        matcher.match_tick(store, obs, xy, yaw, query, key, cam, lcfg,
                           consistency_extra_m=extra)
    finally:
        matcher.ransac_pose = real
    return seen[0]


def hypotheses(path):
    """RANSAC's 3-point samples at a case: P (teach), Q (live) (C, H, 3,
    3) and their weights w (C, H, 3)."""
    from nclt_slam_tpu_torch.landmarks import matcher

    p3d_t, _, p3d_l, valid, keys = ransac_inputs(path)
    P, Q, _, _ = matcher.ransac_samples(p3d_t, p3d_l, valid, keys,
                                        case_config()[1])
    return P[0], Q[0], torch.ones(P.shape[1:-1])


def horn_fixture(path=TIE_CASE) -> dict:
    """The case's hypotheses and ``_horn_starts`` of them on the CPU."""
    from nclt_slam_tpu_torch.landmarks.matcher import _horn_starts

    P, Q, w = hypotheses(path)
    V, rayleigh, mp, mq = _horn_starts(P, Q, w)
    return {k: v.numpy() for k, v in dict(
        P=P, Q=Q, w=w, V=V, rayleigh=rayleigh, mp=mp, mq=mq).items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", type=Path, default=TIE_CASE)
    ap.add_argument("--out", type=Path, default=FIXTURE)
    args = ap.parse_args(argv)
    fx = horn_fixture(args.case)
    np.savez_compressed(args.out, **fx)
    shapes = ", ".join(f"{k} {v.shape}" for k, v in fx.items())
    print(f"wrote {args.out}: {shapes}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
