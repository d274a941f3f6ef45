"""Where the port's FPFH-RANSAC leaves the JAX package's, on the CPU.

Replays the loop candidates of the SLAM fixture (``tests/data/
torch_slam_fixture.npz``: the SLAM scale tool's winter season cut to 401
scans x 128 points) through both packages' RANSAC stage, with the same
threefry keys (``run_slam``'s: ``PRNGKey(0)`` split once per candidate),
and compares them hypothesis by hypothesis: correspondences, each 3-point
Kabsch rotation, each consensus count, the chosen hypothesis.  For every
hypothesis whose rotation differs it reports whether its sample's weighted
cross-covariance has rank <= 1 (two or three correspondences share a
point, so the rotation is whatever the SVD routine returns).

    JAX_PLATFORMS=cpu python tools/torch_ransac_probe.py
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import chip_smoke  # noqa: E402
import torch_slam_scale_test as tool  # noqa: E402
from nclt_slam_tpu.datasets.slam import registration as jreg  # noqa: E402
from nclt_slam_tpu.datasets.slam.icp import _kabsch_weighted  # noqa: E402
from nclt_slam_tpu_torch.core import prng  # noqa: E402
from nclt_slam_tpu_torch.datasets.slam import registration as treg  # noqa: E402

ATOL = 1e-3


@jax.jit
def jax_hypotheses(src, src_valid, dst, dst_valid, key):
    """The body of ``ransac_registration`` in the JAX package, up to its
    argmax: (corr, corr_ok, Rs, ts, counts)."""
    sim = jreg.fpfh(src, src_valid) @ jreg.fpfh(dst, dst_valid).T
    sim = jnp.where(src_valid[:, None] & dst_valid[None, :], sim, -1e9)
    corr = jnp.argmax(sim, axis=1)
    corr_ok = src_valid & (jnp.take_along_axis(
        sim, corr[:, None], axis=1)[:, 0] > -1e8)
    Q = dst[corr]
    picks = jax.random.randint(key, (256, 3), 0, src.shape[0])

    def hypothesis(pick):
        R, t = _kabsch_weighted(src[pick], Q[pick],
                                corr_ok[pick].astype(jnp.float32) + 1e-3)
        resid = jnp.linalg.norm(src @ R.T + t - Q, axis=-1)
        return R, t, ((resid < 0.75) & corr_ok).sum()

    Rs, ts, counts = jax.vmap(hypothesis)(picks)
    return corr, corr_ok, Rs, ts, counts


def main() -> int:
    torch.set_num_threads(1)
    fx = np.load(chip_smoke.SLAM_FIXTURE)
    scans, valid, _, _, _ = tool.season_session(
        int(fx["scans"]), float(fx["laps"]), int(fx["pts"]),
        dict(tool.SEASONS)[str(fx["season"])])
    key, tkey = jax.random.PRNGKey(0), prng.PRNGKey(0, "cpu")
    rows, n_hyp, n_rank1, n_differ, n_differ_rank1 = [], 0, 0, 0, 0
    for e in np.flatnonzero(fx["detected"]):
        key, k = jax.random.split(key)
        tkey, tk = prng.split(tkey).unbind(0)
        i, j = int(fx["loop_i"][e]), int(fx["loop_j"][e])
        a = (scans[j], valid[j], scans[i], valid[i])
        jc, jok, jR, jt, jn = map(np.asarray,
                                  jax_hypotheses(*map(jnp.asarray, a), k))
        src, sv, dst, dv = map(torch.from_numpy, a)
        corr, corr_ok = treg.fpfh_correspondences(src, sv, dst, dv)
        tR, tt, tn, picks = treg.ransac_hypotheses(src, dst[corr], corr_ok,
                                                   tk)
        rank1 = chip_smoke.rank_le_1(src, dst[corr], corr_ok, picks).numpy()
        differ = np.abs(tR.numpy() - jR).max((1, 2)) > ATOL
        n_hyp += len(differ)
        n_rank1 += int(rank1.sum())
        n_differ += int(differ.sum())
        n_differ_rank1 += int((differ & rank1).sum())
        jb, tb = int(jn.argmax()), int(tn.argmax())
        gap = max(np.abs(tR[tb].numpy() - jR[jb]).max(),
                  np.abs(tt[tb].numpy() - jt[jb]).max())
        if gap > ATOL:
            rows.append(dict(
                candidate=int(e),
                correspondences_equal=bool((corr.numpy() == jc).all()
                                           and (corr_ok.numpy() == jok).all()),
                best_jax_port=[jb, tb], best_count_jax_port=[int(jn[jb]),
                                                             int(tn[tb])],
                best_rank_le_1_jax_port=[bool(rank1[jb]), bool(rank1[tb])],
                accepted_by_jax=bool(fx["found"][e])))
    print(json.dumps(dict(
        candidates=int(fx["detected"].sum()),
        ransac_differ=len(rows),
        hypotheses=n_hyp, hypotheses_rank_le_1=n_rank1,
        hypotheses_rotation_differ=n_differ,
        of_them_rank_le_1=n_differ_rank1, differing=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
