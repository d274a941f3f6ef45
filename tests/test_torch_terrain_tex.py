"""The baked terrain texture (``scene/terrain.py:terrain_tex`` /
``terrain_height_tex``) and the raycaster's ``CameraConfig.ray_terrain_tex``
path against the JAX package's, on seeded points and poses.

Tolerances.  The bake is numpy on both sides, the same operations in the
same order: its bits are equal.  The bilinear sample is four gathers and a
handful of float32 products, which XLA on the CPU may contract into fused
multiply-adds: samples agree within 1e-6 m, in range and clamped at the
bounds alike.  ``render_depth`` is held as ``tests/test_torch_modules.py``
holds the analytic field's: hit or miss equal on 99 % of rays (a march
sample on the surface may flip which step first dips below it), depths
within 1e-4 m on 99 % of the rays both hit.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from test_rollout_e2e import tiny_scene  # noqa: E402

from nclt_slam_tpu import config as jcfg  # noqa: E402
from nclt_slam_tpu.scene import terrain as jter  # noqa: E402
from nclt_slam_tpu.sensors import depth as jdepth  # noqa: E402
from nclt_slam_tpu_torch import config as tcfg  # noqa: E402
from nclt_slam_tpu_torch import interop  # noqa: E402
from nclt_slam_tpu_torch.scene import terrain as tter  # noqa: E402
from nclt_slam_tpu_torch.sensors import depth as tdepth  # noqa: E402

SAMPLE_ATOL_M = 1e-6
B = 2


def T(x):
    return torch.from_numpy(np.asarray(x))


def test_terrain_tex_bake_bit_equal_to_jax():
    got, want = tter.terrain_tex(), jter.terrain_tex()
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (tter.TEX_NY, tter.TEX_NX)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("span", [(135.0, 95.0), (200.0, 150.0)],
                         ids=["in_range", "clamped"])
def test_terrain_height_tex_matches_jax(span):
    rng = np.random.RandomState(1)
    x = rng.uniform(-span[0], span[0], 20000).astype(np.float32)
    y = rng.uniform(-span[1], span[1], 20000).astype(np.float32)
    # grid nodes and the far corners, where the clamp and the +1 gathers
    # meet the texture's last row and column
    x[:4] = [tter.TEX_X0, tter.TEX_X0 + 0.25, 140.0, 1e4]
    y[:4] = [tter.TEX_Y0, tter.TEX_Y0 + 0.5, 100.0, -1e4]
    got = tter.terrain_height_tex(T(x), T(y)).numpy()
    want = np.asarray(jter.terrain_height_tex(x, y))
    np.testing.assert_allclose(got, want, rtol=0, atol=SAMPLE_ATOL_M)


def test_render_depth_with_terrain_tex_matches_jax():
    s = tiny_scene(drop_on_path=True)
    jsc = jax.tree_util.tree_map(lambda x: np.stack([np.asarray(x)] * B), s)
    tsc = interop.from_numpy_tree(jsc, "cpu")
    jc = dataclasses.replace(jcfg.DEFAULT.camera, ray_cols=40, ray_rows=30,
                             ray_terrain_tex=True)
    tc = dataclasses.replace(tcfg.DEFAULT.camera, ray_cols=40, ray_rows=30,
                             ray_terrain_tex=True)
    pos = np.array([[8.0, -0.5, 0.3], [15.0, 0.4, 0.2]], np.float32)
    pos[:, 2] = np.asarray(jter.terrain_height(pos[:, 0], pos[:, 1])) + 0.13
    yaw = np.array([0.2, 2.6], np.float32)
    jd, _, jv = jax.vmap(lambda p, w, a, b, c, d, e: jdepth.render_depth(
        p, w, a, b, c, d, e, jc))(pos, yaw, jsc.xy, jsc.radius, jsc.base_z,
                                  jsc.height, jsc.valid)
    td, _, tv = tdepth.render_depth(T(pos), T(yaw), tsc.xy, tsc.radius,
                                    tsc.base_z, tsc.height, tsc.valid, tc)
    jv, tv = np.asarray(jv), tv.numpy()
    assert jv.mean() > 0.5
    assert (jv == tv).mean() > 0.99
    both = jv & tv
    close = np.abs(td.numpy() - np.asarray(jd)) < 1e-4
    assert close[both].mean() > 0.99
    # the flag reaches the march: the texture moves some depths
    ta, _, _ = tdepth.render_depth(
        T(pos), T(yaw), tsc.xy, tsc.radius, tsc.base_z, tsc.height,
        tsc.valid, dataclasses.replace(tc, ray_terrain_tex=False))
    assert not torch.equal(ta, td)
