"""The port's v55 relay against the JAX package on the CPU: a 300-tick
sequence per route (standstill alignment window, a drive with turns,
anchors of every strength, SLAM dropouts and a frozen stretch, a jump),
as ``tests/test_fusion.py`` drives it, three routes in one batch.

Tolerance: the regime sequences are equal; the published pose agrees to
1e-4 m (float32 rounding of the 4x4 products and of the closed-form rigid
inverse the port uses for ``jnp.linalg.inv``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nclt_slam_tpu.config import DEFAULT
from nclt_slam_tpu.fusion import anchor_update, fusion_tick, init_fusion
from nclt_slam_tpu.fusion.relay import T_FLU_FROM_CAM
from nclt_slam_tpu_torch import interop
from nclt_slam_tpu_torch.config import DEFAULT as TDEFAULT
from nclt_slam_tpu_torch.core import lie
from nclt_slam_tpu_torch.fusion import relay as tr

# the test workers share the CPU: one intra-op thread each keeps their
# torch thread pools from oversubscribing it
torch.set_num_threads(1)

TICKS = 300
R = 3


def _slam_pose(x, y, yaw):
    from scipy.spatial.transform import Rotation

    F = np.asarray(T_FLU_FROM_CAM, np.float64)
    c, s = np.cos(yaw), np.sin(yaw)
    T_nav = np.array([[c, -s, 0, x], [s, c, 0, y], [0, 0, 1, 0],
                      [0, 0, 0, 1]])
    T = np.linalg.inv(F) @ T_nav @ F
    return T[:3, 3], Rotation.from_matrix(T[:3, :3]).as_quat()


def _tracks():
    """Per route: GT (x, y, yaw), SLAM pose with a drift, slam_ok, and
    anchors {tick: (x, y, std)}."""
    rng = np.random.RandomState(0)
    out = []
    for r in range(R):
        x = y = yaw = 0.0
        gts, ts, qs, oks = [], [], [], []
        for i in range(TICKS):
            if i >= 60:
                yaw += 0.02 * np.sin(i / (20.0 + 5 * r))
                x += 0.05 * np.cos(yaw)
                y += 0.05 * np.sin(yaw)
            gts.append((x, y, yaw))
            drift = 0.004 * max(i - 60, 0) * (1 + r)
            sx, sy = x + drift, y - 0.5 * drift
            if r == 1 and i == 200:
                sx += 3.0                            # a relocalization snap
            if r == 2 and 150 <= i < 240:            # SLAM frozen
                sx, sy = gts[149][0] + 0.0, gts[149][1]
            t, q = _slam_pose(sx, sy, yaw)
            ts.append(t)
            qs.append(q)
            oks.append(not (r == 0 and 120 <= i < 130))
        anchors = {}
        for i in range(70 + 3 * r, TICKS, 5 + r):
            std = (0.05, 0.15, 0.3)[(i // 7) % 3]
            gx, gy, _ = gts[i]
            anchors[i] = (gx + rng.normal(0, 0.3), gy + rng.normal(0, 0.3),
                          std)
        out.append((np.array(gts, np.float32), np.array(ts, np.float32),
                    np.array(qs, np.float32), np.array(oks), anchors))
    return out


def test_relay_sequence_matches_jax():
    enc = dataclasses.replace(DEFAULT.encoder, compass_drift=0.01)
    tenc = dataclasses.replace(TDEFAULT.encoder, compass_drift=0.01)
    fcfg, tfcfg = DEFAULT.fusion, TDEFAULT.fusion
    tracks = _tracks()
    j_tick = jax.jit(jax.vmap(
        lambda st, gx, gy, gyaw, t, q, ok, k, tk: fusion_tick(
            st, gx, gy, gyaw, t, q, ok, tk, k, enc, fcfg),
        in_axes=(0, 0, 0, 0, 0, 0, 0, 0, None)))
    j_anchor = jax.jit(jax.vmap(
        lambda st, xy, std, tk: anchor_update(st, xy, std, tk, fcfg),
        in_axes=(0, 0, 0, None)))
    jst = jax.vmap(lambda _: init_fusion(fcfg))(jnp.arange(R))
    tst = tr.init_fusion(tfcfg, R, "cpu")
    keys = jax.random.split(jax.random.PRNGKey(4), R)
    j_nav, t_nav, j_reg, t_reg = [], [], [], []
    for i in range(TICKS):
        has = np.array([i in tk[4] for tk in tracks])
        if has.any():
            axy = np.array([tk[4].get(i, (0.0, 0.0, 1.0))[:2]
                            for tk in tracks], np.float32)
            astd = np.array([tk[4].get(i, (0.0, 0.0, 1.0))[2]
                             for tk in tracks], np.float32)
            j_up = j_anchor(jst, axy, astd, jnp.int32(i))
            jst = jax.tree_util.tree_map(
                lambda n, o: jnp.where(
                    jnp.asarray(has).reshape((R,) + (1,) * (n.ndim - 1)),
                    n, o), j_up, jst)
            t_up = tr.anchor_update(tst, torch.from_numpy(axy),
                                    torch.from_numpy(astd), i, tfcfg)
            tst = tr.select_routes(torch.from_numpy(has), t_up, tst)
        gt = np.stack([tk[0][i] for tk in tracks])
        t = np.stack([tk[1][i] for tk in tracks])
        q = np.stack([tk[2][i] for tk in tracks])
        ok = np.array([tk[3][i] for tk in tracks])
        keys, sub = jnp.split(jax.vmap(jax.random.split)(keys), 2, axis=1)
        keys, sub = keys[:, 0], sub[:, 0]
        jst, jx, jy, _, jr = j_tick(jst, gt[:, 0], gt[:, 1], gt[:, 2], t, q,
                                    ok, sub, jnp.int32(i))
        tst, tx, ty, _, trg = tr.fusion_tick(
            tst, *(torch.from_numpy(gt[:, k]) for k in range(3)),
            torch.from_numpy(t), torch.from_numpy(q), torch.from_numpy(ok),
            i, torch.from_numpy(np.asarray(sub).astype(np.int64)), tenc,
            tfcfg)
        j_nav.append(np.stack([jx, jy], -1))
        t_nav.append(torch.stack([tx, ty], -1).numpy())
        j_reg.append(np.asarray(jr))
        t_reg.append(trg.numpy())
    j_reg, t_reg = np.stack(j_reg, 1), np.stack(t_reg, 1)
    assert np.array_equal(t_reg, j_reg)
    np.testing.assert_allclose(np.stack(t_nav, 1), np.stack(j_nav, 1),
                               atol=1e-4)
    # the sequence exercised every regime and the committed alignment
    assert set(np.unique(j_reg)) == {0, 1, 2, 3}
    assert bool(np.asarray(jst.committed).all())
    assert np.array_equal(tst.committed.numpy(), np.asarray(jst.committed))
    np.testing.assert_allclose(tst.T_nav_slam.numpy(),
                               np.asarray(jst.T_nav_slam), atol=1e-5)
    assert np.array_equal(tst.frozen_count.numpy(),
                          np.asarray(jst.frozen_count))
    assert np.array_equal(interop.to_numpy_tree(tst.strong_streak),
                          np.asarray(jst.strong_streak))


def test_rigid_inverse_and_wrap():
    """The closed-form rigid inverse the relay uses for ``jnp.linalg.inv``
    and ``wrap_angle`` (``jnp.angle(exp(1j x))``)."""
    rng = np.random.RandomState(1)
    from scipy.spatial.transform import Rotation
    Rm = Rotation.random(5, random_state=rng).as_matrix().astype(np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    T[:, :3, :3] = Rm
    T[:, :3, 3] = rng.normal(0, 10, (5, 3))
    inv = lie.se3_inverse(torch.from_numpy(T)).numpy()
    np.testing.assert_allclose(inv, np.linalg.inv(T), atol=1e-5)
    x = rng.uniform(-20, 20, 100).astype(np.float32)
    np.testing.assert_allclose(
        lie.wrap_angle(torch.from_numpy(x)).numpy(),
        np.asarray(jnp.angle(jnp.exp(1j * jnp.asarray(x)))), atol=1e-5)
