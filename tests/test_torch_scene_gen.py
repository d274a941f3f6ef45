"""The port's scene and route generators (``nclt_slam_tpu_torch/scene/``)
against the JAX package's, and the port's own scene cache.

The generators are host numpy in both packages, the port's a copy of the
JAX package's operation for operation and draw for draw (the same
``RandomState`` streams in the same order, the float32 distance field), so
everything here is held bit for bit: the base scene, the walled scene, all
15 routes, the grid and each stage of the route pipeline.  The last three
tests hold the port's depth sampler and occupancy helpers against JAX's by
tolerance (float32 rounding of XLA's sin/cos and fused multiply-adds).
"""

import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nclt_slam_tpu import config as jcfg
from nclt_slam_tpu.mapping import occupancy as jocc
from nclt_slam_tpu.scene import colliders as jcol
from nclt_slam_tpu.scene import routes as jroutes
from nclt_slam_tpu.scene import terrain as jter
from nclt_slam_tpu.sensors import depth as jdepth
from nclt_slam_tpu_torch import config as tcfg
from nclt_slam_tpu_torch.mapping import occupancy as tocc
from nclt_slam_tpu_torch.scene import colliders as tcol
from nclt_slam_tpu_torch.scene import routes as troutes
from nclt_slam_tpu_torch.sensors import depth as tdepth

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SEED = 7
ROUTE_FIELDS = ("dense_xy", "n_dense", "spawn", "spawn_yaw", "turnaround",
                "turnaround_idx")


def same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def assert_scene_equal(got, want):
    for f in jcol.SceneColliders._fields:
        assert same(getattr(got, f), getattr(want, f)), f


def assert_route_equal(got, want):
    for f in ROUTE_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, np.ndarray):
            assert same(a, b), f
        else:
            assert a == b and type(a) is type(b), f


@pytest.fixture(scope="module")
def regen():
    """The port's generator run from nothing, as ``default_scene`` runs it
    on a cache miss: the base scene, its grid, the 15 routes, the walls."""
    base = tcol.build_scene(SEED)
    grid = troutes.build_grid(base)
    routes = {n: troutes.generate_route(n, base, grid)
              for n in troutes.ALL_ROUTES}
    paths = [np.asarray(r.dense_xy[:r.n_dense], np.float64)
             for r in routes.values()]
    walled = tcol.add_route_walls(base, paths, SEED)
    return base, grid, routes, walled


def test_build_scene_matches_jax(regen):
    base, grid, _, _ = regen
    jbase = jcol.build_scene(SEED)
    assert_scene_equal(base, jbase)
    assert same(grid, jroutes.build_grid(jbase))
    assert base.count == jbase.count


def test_walled_scene_matches_jax_default_scene(regen):
    walled = regen[3]
    assert_scene_equal(walled, jcol.default_scene(SEED))
    assert walled.count > regen[0].count


@pytest.mark.parametrize("name", troutes.ALL_ROUTES)
def test_generate_route_matches_jax(regen, name):
    assert_route_equal(regen[2][name], jroutes.get_route(name, SEED))


def test_committed_cache_equals_regeneration(regen):
    """The port's scene/data/*.npz hold exactly its own generator's output
    (and name no other directory)."""
    d = tcol.DATA_DIR
    assert d == Path(tcol.__file__).resolve().parent / "data"
    assert "nclt_slam_tpu_torch" in d.parts
    names = sorted(p.name for p in d.glob("*.npz"))
    assert names == sorted([f"scene_seed{SEED}.npz"] + [
        f"route_{n}_seed{SEED}.npz" for n in troutes.ALL_ROUTES])
    with np.load(d / f"scene_seed{SEED}.npz") as z:
        assert_scene_equal(tcol.SceneColliders(**{k: z[k] for k in z.files}),
                           regen[3])
    for n, r in regen[2].items():
        with np.load(d / f"route_{n}_seed{SEED}.npz") as z:
            assert same(z["dense_xy"], r.dense_xy)
            assert int(z["n_dense"]) == r.n_dense
            assert float(z["spawn_yaw"]) == r.spawn_yaw
            assert int(z["turnaround_idx"]) == r.turnaround_idx
            assert tuple(z["spawn"]) == r.spawn
            assert tuple(z["turnaround"]) == r.turnaround
    assert_scene_equal(tcol.default_scene(SEED), regen[3])
    assert_route_equal(troutes.get_route("05_ne_sw", SEED),
                       regen[2]["05_ne_sw"])


def small_grid(seed: int, H: int = 30, W: int = 40):
    rng = np.random.RandomState(seed)
    grid = rng.rand(H, W) < 0.2
    grid[:, W // 2] = True                 # a wall with one gap
    grid[H // 3, W // 2] = False
    goal = (H - 2, W - 3)
    grid[goal] = False
    return grid, goal


@pytest.mark.parametrize("seed", [0, 1])
def test_distance_field_and_descent_match_jax(seed):
    grid, goal = small_grid(seed)
    got = troutes.distance_field(grid, goal)
    want = jroutes.distance_field(grid, goal)
    assert same(got, want)
    reach = np.argwhere(want < jroutes._INF)
    assert len(reach) > 100
    start = tuple(reach[len(reach) // 7])
    assert same(troutes.trace_descent(got, start),
                jroutes.trace_descent(want, start))
    for dr, dc in ((1, -1), (-2, 3), (0, 0)):
        assert same(troutes._shifted(got, dr, dc, troutes._INF),
                    jroutes._shifted(want, dr, dc, jroutes._INF))
    rc = np.array([H_ // 2 for H_ in grid.shape])
    assert troutes._snap_free(grid, rc) == jroutes._snap_free(grid, rc)
    xy = np.random.RandomState(seed).uniform(-100, 70, (7, 2))
    assert same(troutes._world_to_cell(xy), jroutes._world_to_cell(xy))
    cells = troutes._world_to_cell(xy)
    assert same(troutes._cell_to_world(cells), jroutes._cell_to_world(cells))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_smoothing_and_hairpin_match_jax(seed):
    rng = np.random.RandomState(seed)
    pts = np.cumsum(rng.uniform(-0.5, 1.0, (60, 2)), 0) * 0.7
    for step in (1.0, 3.5):
        assert same(troutes.decimate(pts, step), jroutes.decimate(pts, step))
    assert same(troutes.round_corners(pts, 2), jroutes.round_corners(pts, 2))
    for ds in (0.3, 0.8):
        assert same(troutes.resample(pts, ds), jroutes.resample(pts, ds))
    sm = troutes.resample(troutes.round_corners(troutes.decimate(pts)), 0.8)
    # obstacles near the tip: some arcs blocked, and none (a retrace)
    tip = sm[-1]
    oxy = tip + rng.uniform(-4.0, 4.0, (12, 2))
    orad = rng.uniform(0.2, 0.9, 12)
    for o, r in ((oxy, orad), (np.zeros((0, 2)), np.zeros(0)),
                 (tip[None] + 0.1, np.array([5.0]))):
        assert same(troutes.hairpin_return(sm, o, r),
                    jroutes.hairpin_return(sm, o, r))


def test_port_loads_and_regenerates_without_the_jax_package(tmp_path):
    """A copy of the port alone (no ``nclt_slam_tpu`` directory): it loads
    the scene and a route from its own cache, and regenerates a missing
    route file with its own generator."""
    pkg = tmp_path / "nclt_slam_tpu_torch"
    shutil.copytree(REPO / "nclt_slam_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    missing = pkg / "scene" / "data" / f"route_11_nw_mid_seed{SEED}.npz"
    missing.unlink()
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from nclt_slam_tpu_torch.scene import default_scene, get_route\n"
        "from nclt_slam_tpu_torch.scene.colliders import DATA_DIR\n"
        "s = default_scene()\n"
        "r = get_route('03_south')\n"
        "m = get_route('11_nw_mid')\n"
        "assert (DATA_DIR / 'route_11_nw_mid_seed7.npz').is_file()\n"
        "bad = [k for k in sys.modules if k == 'jax' or "
        "k.split('.')[0] == 'nclt_slam_tpu']\n"
        "assert not bad, bad\n"
        "np.savez(sys.argv[1], s_xy=s.xy, s_valid=s.valid, r=r.dense_xy, "
        "m=m.dense_xy, dirname=str(DATA_DIR))\n")
    out = tmp_path / "out.npz"
    env = dict(os.environ, PYTHONPATH=str(tmp_path), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code, str(out)],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert not (tmp_path / "nclt_slam_tpu").exists()
    z = np.load(out)
    assert str(z["dirname"]).startswith(str(tmp_path))
    want = jcol.default_scene(SEED)
    assert same(z["s_xy"], want.xy) and same(z["s_valid"], want.valid)
    assert same(z["r"], jroutes.get_route("03_south", SEED).dense_xy)
    assert same(z["m"], jroutes.get_route("11_nw_mid", SEED).dense_xy)


def test_generate_routes_cli_matches_jax(tmp_path, capsys):
    """``cli.generate_routes`` writes JAX's routes.json and drafts byte for
    byte and the same overview plot (decoded pixels equal)."""
    from PIL import Image

    from nclt_slam_tpu.cli import generate_routes as jgen
    from nclt_slam_tpu_torch.cli import generate_routes as tgen

    argv = ["--routes", "01_road,08_nw_sw", "--seed", str(SEED)]
    assert jgen.main(argv + ["--out", str(tmp_path / "j")]) == 0
    jout = capsys.readouterr().out
    assert tgen.main(argv + ["--out", str(tmp_path / "t")]) == 0
    tout = capsys.readouterr().out
    assert tout.replace(str(tmp_path / "t"), str(tmp_path / "j")) == jout
    for f in ("routes.json", "drafts/route_01_road.csv",
              "drafts/route_08_nw_sw.csv"):
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes(), f
    with Image.open(tmp_path / "t" / "routes_plan.png") as a, \
            Image.open(tmp_path / "j" / "routes_plan.png") as b:
        assert a.size == b.size
        assert np.array_equal(np.asarray(a), np.asarray(b))


def colliders(rng, n=24):
    xy = rng.uniform(-6.0, 14.0, (n, 2)).astype(np.float32)
    radius = rng.uniform(0.3, 1.0, n).astype(np.float32)
    base_z = np.asarray(jter.terrain_height(xy[:, 0], xy[:, 1]))
    height = rng.uniform(0.5, 8.0, n).astype(np.float32)
    valid = rng.rand(n) > 0.2
    return xy, radius, base_z, height, valid


def test_sample_depth_at_pixels_matches_jax():
    """Depth of arbitrary pixels: valid flags equal, depths within 1e-4 m
    (the raycaster's tolerance, ``test_torch_modules.py``)."""
    rng = np.random.RandomState(5)
    jc, tc = jcfg.DEFAULT.camera, tcfg.DEFAULT.camera
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    pos = np.array([[0.0, 0.5, 0.0], [3.0, -1.0, 0.0]], np.float32)
    pos[:, 2] = np.asarray(jter.terrain_height(pos[:, 0], pos[:, 1])) + 0.13
    yaw = np.array([0.1, -0.4], np.float32)
    us = rng.uniform(0, jc.width, (2, 64)).astype(np.float32)
    vs = rng.uniform(0, jc.height, (2, 64)).astype(np.float32)
    obs = [colliders(rng) for _ in range(2)]
    stacked = [np.stack(f) for f in zip(*obs)]
    jd, jv = jax.vmap(lambda p, y, u, v, a, b, c, d, e:
                      jdepth.sample_depth_at_pixels(p, y, u, v, a, b, c, d, e,
                                                    jc))(
        pos, yaw, us, vs, *stacked)
    td, tv = tdepth.sample_depth_at_pixels(
        *(torch.from_numpy(a) for a in (pos, yaw, us, vs, *stacked)), tc)
    jd, jv = np.asarray(jd), np.asarray(jv)
    assert 0.2 < jv.mean() and (~jv).any()
    assert np.array_equal(tv.numpy(), jv)
    np.testing.assert_allclose(td.numpy(), jd, atol=1e-4)


def test_cell_to_world_and_in_bounds_match_jax():
    jm, tm = jcfg.DEFAULT.map, tcfg.DEFAULT.map
    rng = np.random.RandomState(2)
    r = rng.randint(-5, tm.rows + 5, 200).astype(np.int32)
    c = rng.randint(-5, tm.cols + 5, 200).astype(np.int32)
    jx, jy = jocc.cell_to_world(jnp.asarray(r), jnp.asarray(c), jm)
    tx, ty = tocc.cell_to_world(torch.from_numpy(r), torch.from_numpy(c), tm)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    jb = np.asarray(jocc.in_bounds(jnp.asarray(r), jnp.asarray(c), jm))
    tb = tocc.in_bounds(torch.from_numpy(r), torch.from_numpy(c), tm).numpy()
    assert np.array_equal(tb, jb) and jb.any() and (~jb).any()
    # the round trip through world_to_cell lands on the same cell
    rr, cc = tocc.world_to_cell(tx, ty, tm)
    assert np.array_equal(rr.numpy(), r) and np.array_equal(cc.numpy(), c)
