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

``chip_smoke.py``'s texture check (``tex_hit_measures``) on single rays:
a ray that grazes the terrain puts its analytic and its textured hit
metres apart along it, both on the surface, so their vertical gap exceeds
the bound while the textured hit's height against the analytic terrain
holds it, and the ray between the two hits stays on the surface; a texture
0.1 m too high fails the height measure; a textured hit that a march
returns past a crest it tunnelled through lies on the surface, but its
ray runs under the crest, which the sink measure refuses.  At the near
clip a ray already under the terrain has its hit under the surface in
both marches, which is not refused; a textured clip of a ray above the
terrain, or a textured hit past a crest the ray starts in, is.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
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


NEAR = tcfg.DEFAULT.camera.depth_min

# a pose on route 03_south (x, y, yaw) and a ray of its 80 x 60 grid (row,
# col) that leaves the camera 1.9 degrees below horizontal
GRAZING = ((14.6312894821167, -4.5221147537231445, 3.0064539909362793),
           (31, 19))


def grazing_ray(h_tex=None, monkeypatch=None):
    """(origin, dirs, t_off, t_on) of the grazing ray; ``h_tex`` replaces
    the textured height field."""
    from nclt_slam_tpu_torch.dynamics.diffdrive import _pose3d

    (x, y, yaw), (r, c) = GRAZING
    xy = torch.tensor([[x, y]], dtype=torch.float32)
    yaw = torch.tensor([yaw], dtype=torch.float32)
    pos3, _ = _pose3d(xy, yaw)
    cams = {f: dataclasses.replace(tcfg.DEFAULT.camera, ray_terrain_tex=f)
            for f in (False, True)}
    origin, R = tdepth.camera_pose(pos3, yaw, cams[False])
    dirs = tdepth._rotate(R, tdepth.ray_grid(cams[False], "cpu")[None])
    dirs = dirs[:, r:r + 1, c:c + 1]
    if h_tex is not None:
        monkeypatch.setattr(tdepth, "terrain_height_tex", h_tex)
    t_off = tdepth._terrain_hit(origin, dirs, cams[False])
    t_on = tdepth._terrain_hit(origin, dirs, cams[True])
    return origin, dirs, t_off, t_on, chip_smoke.tex_bound(cams[False])


def test_tex_check_holds_a_grazing_ray_by_its_height():
    origin, dirs, t_off, t_on, bound = grazing_ray()
    assert abs(float(dirs[0, 0, 0, 2])) < 0.04
    both, gap, height_err, sink = chip_smoke.tex_hit_measures(
        origin, dirs, t_off, t_on, NEAR)
    assert bool(both.all())
    assert abs(float(t_on - t_off)) > 2.0          # metres apart along it
    assert float(gap.max()) > bound                # the old measure fails
    assert float(height_err.max()) <= bound        # the new one holds
    assert float(height_err.max()) < 0.01
    assert float(sink.max()) <= bound              # no crossing skipped


def test_tex_check_refuses_a_wrong_height(monkeypatch):
    wrong = tter.terrain_height_tex

    def too_high(x, y):
        return wrong(x, y) + 0.1

    origin, dirs, t_off, t_on, bound = grazing_ray(too_high, monkeypatch)
    both, _, height_err, _ = chip_smoke.tex_hit_measures(origin, dirs, t_off,
                                                         t_on, NEAR)
    assert bool(both.all())
    assert float(height_err.max()) > bound


def crest_terrain(x, y):
    """A plane at z = 0 with a 1 m crest across 2 m <= x <= 3 m."""
    return torch.where((x >= 2.0) & (x <= 3.0), 1.0, 0.0) + 0.0 * y


def test_tex_check_refuses_a_skipped_crossing(monkeypatch):
    monkeypatch.setattr(tter, "terrain_height", crest_terrain)
    # a ray from 0.3 m up that falls 3 cm a metre: into the crest at x = 2
    # (the analytic hit), out of it at x = 3, onto the plane at x = 10,
    # where a march that skipped the crest would stop
    origin = torch.tensor([[0.0, 0.0, 0.3]])
    d = torch.tensor([1.0, 0.0, -0.03])
    dirs = (d / d.norm()).reshape(1, 1, 1, 3)
    t_off = torch.full((1, 1, 1), 2.0 * float(d.norm()))
    t_on = torch.full((1, 1, 1), 10.0 * float(d.norm()))
    bound = chip_smoke.tex_bound(tcfg.DEFAULT.camera)
    both, gap, height_err, sink = chip_smoke.tex_hit_measures(
        origin, dirs, t_off, t_on, NEAR)
    assert bool(both.all())
    assert float(height_err.max()) <= bound        # the hit is on the plane
    assert float(sink.max()) > bound               # its ray ran underground
    assert float(sink.max()) == pytest.approx(0.79, abs=0.01)


@pytest.mark.parametrize("z0,t_off,t_on,refused", [
    (0.3, NEAR, NEAR, False),   # in the crest: both marches clip at the near
    (0.3, NEAR, 4.0, True),     # ... the textured one hitting past the crest
    (1.1, 5.0, NEAR, True),     # above the crest: a textured clip is wrong
], ids=["both_clipped", "clip_moved_past_the_crest", "clip_above_terrain"])
def test_tex_check_at_the_near_clip(monkeypatch, z0, t_off, t_on, refused):
    """A ray that starts inside the crest is under the terrain at the near
    clip: both marches return the clip, which lies under the surface, not
    on it, and nothing is refused; a textured hit past the crest is (its
    ray ran under it), and so is a textured hit at the clip of a ray that
    is above the terrain there."""
    monkeypatch.setattr(tter, "terrain_height", crest_terrain)
    origin = torch.tensor([[2.0, 0.0, z0]])
    dirs = torch.tensor([1.0, 0.0, 0.0]).reshape(1, 1, 1, 3)
    bound = chip_smoke.tex_bound(tcfg.DEFAULT.camera)
    both, _, height_err, sink = chip_smoke.tex_hit_measures(
        origin, dirs, torch.full((1, 1, 1), t_off),
        torch.full((1, 1, 1), t_on), NEAR)
    assert bool(both.all())
    worst = max(float(height_err.max()), float(sink.max()))
    assert (worst > bound) == refused
