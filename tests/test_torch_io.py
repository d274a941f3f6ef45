"""The port's artefact I/O (``nclt_slam_tpu_torch/io``) against the JAX
package's, on the CPU.

The same seeded numpy inputs go through both packages' writers: the teach
map (PGM + YAML), the CSV artefacts and the TUM trajectory come out
byte-equal, the ``landmarks.pkl`` payloads equal in every key, type,
dtype and value; each package's loaders read the other's files to the
same arrays.  The native library agrees with its numpy fallbacks exactly
(``tests/test_native.py``'s cases; the unpacked velodyne floats within
2e-5, their 1-ulp rounding order).  The port's checkpoint resumes a
repeat bit for bit, and its loader refuses a JAX checkpoint without
importing JAX.
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nclt_slam_tpu.config import DEFAULT as JCFG
from nclt_slam_tpu.io import artifacts as jart
from nclt_slam_tpu.io import native as jnative
from nclt_slam_tpu.landmarks.store import LandmarkStore as JStore
from nclt_slam_tpu_torch import config as tcfg_mod
from nclt_slam_tpu_torch.io import artifacts as tart
from nclt_slam_tpu_torch.io import native as tnative
from nclt_slam_tpu_torch.landmarks.store import LandmarkStore as TStore

REPO = Path(__file__).resolve().parents[1]
CLI_FIXTURE = REPO / "tests" / "data" / "torch_cli_fixture.npz"
TCFG = tcfg_mod.DEFAULT

torch.set_num_threads(1)

# a small landmark store: capacity 6 x 16 features x 8 words, 4 recorded
L, F, W, COUNT = 6, 16, 8, 4


def landmark_cfgs():
    kw = dict(max_landmarks=L, feats_per_landmark=F)
    return (dataclasses.replace(JCFG.landmarks, **kw),
            dataclasses.replace(TCFG.landmarks, **kw))


def random_store(seed: int = 0) -> dict:
    """Store fields (unbatched numpy); descriptors span the whole uint32
    range, so that a signed view would break them."""
    rng = np.random.RandomState(seed)
    desc = rng.randint(0, 2**32, (L, F, W), dtype=np.uint64).astype(np.uint32)
    desc[0, 0] = 0xFFFFFFFF
    desc[1, 0] = 0x80000000
    fval = rng.rand(L, F) < 0.7
    fval[COUNT:] = False
    return dict(
        cam_pos=rng.randn(L, 3).astype(np.float32) * 20,
        cam_yaw=rng.uniform(-3.1, 3.1, L).astype(np.float32),
        desc=desc,
        p3d_cam=rng.randn(L, F, 3).astype(np.float32) * 5,
        uv=rng.uniform(0, 640, (L, F, 2)).astype(np.float32),
        feat_valid=fval,
        n_feats=fval.sum(1).astype(np.int32),
        count=np.int32(COUNT),
        last_pos=np.zeros(2, np.float32),
        has_last=np.bool_(True))


def jax_store(f: dict) -> JStore:
    return JStore(**{k: jnp.asarray(v) for k, v in f.items()})


def port_store(f: dict) -> TStore:
    def t(v):
        a = np.asarray(v)
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        return torch.from_numpy(np.array(a))[None]
    return TStore(**{k: t(v) for k, v in f.items()})


def assert_payload_equal(a, b, where="payload"):
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            assert_payload_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_payload_equal(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert a.tobytes() == b.tobytes(), where
    else:
        assert a == b, where


def test_landmarks_pkl_payload_equal(tmp_path):
    jl, tl = landmark_cfgs()
    fields = random_store()
    jp = jart.save_landmarks_pkl(jax_store(fields), tmp_path / "j.pkl",
                                 JCFG.camera, jl)
    tp = tart.save_landmarks_pkl(port_store(fields), tmp_path / "t.pkl",
                                 TCFG.camera, tl)
    assert_payload_equal(tp, jp)
    for p in ("j.pkl", "t.pkl"):       # what a reader gets from the file
        with open(tmp_path / p, "rb") as f:
            assert_payload_equal(pickle.load(f), jp, p)
    d = tp["landmarks"][0]["descriptors"]
    assert d.dtype == np.uint8 and d.shape[1] == 32 and d.max() == 255
    assert len(tp["landmarks"]) == COUNT
    assert all(isinstance(v, float) for v in tp["landmarks"][1]["pose"])


def test_landmarks_pkl_each_package_reads_the_other(tmp_path):
    jl, tl = landmark_cfgs()
    fields = random_store(1)
    jart.save_landmarks_pkl(jax_store(fields), tmp_path / "j.pkl",
                            JCFG.camera, jl)
    tart.save_landmarks_pkl(port_store(fields), tmp_path / "t.pkl",
                            TCFG.camera, tl)
    j_reads_t = jart.load_landmarks_pkl(tmp_path / "t.pkl", jl)
    t_reads_j = tart.load_landmarks_pkl(tmp_path / "j.pkl", tl, "cpu")
    assert t_reads_j.count.shape == (1,)
    for name in JStore._fields:
        a = np.asarray(getattr(j_reads_t, name))
        b = getattr(t_reads_j, name)[0].numpy()
        if name == "desc":
            assert b.dtype == np.int64 and b.max() > 2**31
            b = b.astype(np.uint32)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    # the descriptors survive the round trip bit for bit, high bits set
    n = int(fields["feat_valid"][0].sum())
    assert np.array_equal(t_reads_j.desc[0, 0, :n].numpy().astype(np.uint32),
                          fields["desc"][0][fields["feat_valid"][0]])


def test_landmarks_pkl_refuses_a_batch():
    _, tl = landmark_cfgs()
    fields = random_store()
    store = port_store(fields)
    two = TStore(*(torch.cat([x, x]) for x in store))
    with pytest.raises(ValueError, match="one route"):
        tart.save_landmarks_pkl(two, "unused.pkl", TCFG.camera, tl)


def test_teach_map_bytes_equal_and_cross_read(tmp_path):
    rng = np.random.RandomState(2)
    tri = rng.randint(0, 3, (57, 83)).astype(np.int8)
    prefix = tmp_path / "teach_map"
    jart.save_teach_map(tri, prefix, JCFG.map)
    ref = {s: Path(f"{prefix}.{s}").read_bytes() for s in ("pgm", "yaml")}
    j_grid = jart.load_teach_map(prefix)
    t_grid = tart.load_teach_map(prefix)        # the port reads JAX's file
    tart.save_teach_map(torch.from_numpy(tri), prefix, TCFG.map)
    for s in ("pgm", "yaml"):
        assert Path(f"{prefix}.{s}").read_bytes() == ref[s], s
    for a, b in zip(j_grid, t_grid):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    grid, res, origin = jart.load_teach_map(prefix)   # JAX reads the port's
    assert grid.dtype == t_grid[0].dtype == np.int8
    assert np.array_equal(grid, tri) and np.array_equal(t_grid[0], tri)
    assert res == TCFG.map.resolution
    assert origin == [TCFG.map.origin_x, TCFG.map.origin_y, 0.0]


def test_csv_and_tum_bytes_equal_and_cross_read(tmp_path):
    rng = np.random.RandomState(3)
    n = 37
    ts = np.arange(n) * 0.1
    slam = rng.randn(n, 7).astype(np.float32) * 30
    gt = rng.randn(n, 2).astype(np.float32) * 50
    yaw = rng.uniform(-3, 3, n).astype(np.float32)
    quat = rng.randn(n, 4).astype(np.float32)
    cases = [
        ("vio_pose_dense.csv", "save_vio_pose_dense", (ts, slam, gt),
         "load_vio_pose_dense"),
        ("traj_gt.csv", "save_traj_gt", (ts, gt, yaw), "load_traj_gt"),
        ("traj_gt_noyaw.csv", "save_traj_gt", (ts, gt), "load_traj_gt"),
        ("tum.txt", "save_tum_trajectory", (ts, slam[:, :3], quat), None),
    ]
    for name, save, args, load in cases:
        jp, tp = tmp_path / f"j_{name}", tmp_path / f"t_{name}"
        getattr(jart, save)(jp, *args)
        getattr(tart, save)(tp, *(torch.from_numpy(np.asarray(a))
                                  for a in args))
        assert jp.read_bytes() == tp.read_bytes(), name
        if load:
            a = getattr(jart, load)(tp)
            b = getattr(tart, load)(jp)
            assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_port_reads_the_jax_cli_teach_files(tmp_path):
    """The JAX CLI's teach directory (recorded in the CLI fixture): the
    port's loaders give the JAX loaders' arrays."""
    with np.load(CLI_FIXTURE) as z:
        for name in ("teach_map.pgm", "teach_map.yaml", "landmarks.pkl",
                     "vio_pose_dense.csv", "traj_gt.csv"):
            (tmp_path / name).write_bytes(z[f"teach/{name}"].tobytes())
    for a, b in zip(jart.load_teach_map(tmp_path / "teach_map"),
                    tart.load_teach_map(tmp_path / "teach_map")):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    for name, load in (("vio_pose_dense.csv", "load_vio_pose_dense"),
                       ("traj_gt.csv", "load_traj_gt")):
        assert np.array_equal(getattr(jart, load)(tmp_path / name),
                              getattr(tart, load)(tmp_path / name))
    j = jart.load_landmarks_pkl(tmp_path / "landmarks.pkl", JCFG.landmarks)
    t = tart.load_landmarks_pkl(tmp_path / "landmarks.pkl", TCFG.landmarks,
                                "cpu")
    assert int(t.count[0]) >= 1
    for name in JStore._fields:
        a = np.asarray(getattr(j, name))
        b = getattr(t, name)[0].numpy()
        assert np.array_equal(a, b.astype(a.dtype)), name


# ---------------------------------------------------------------------------
# native library vs fallbacks
# ---------------------------------------------------------------------------

def fallback(fn, *args):
    """``fn`` on the port's numpy fallback path."""
    lib, tnative._lib, tnative._build_failed = tnative._lib, None, True
    try:
        return fn(*args)
    finally:
        tnative._lib, tnative._build_failed = lib, False


def test_native_library_is_found():
    assert tnative._NATIVE_DIR == REPO / "native"
    assert tnative.have_native(), "g++ build of native/artefact_io.cpp failed"
    assert tnative._LIB_PATH.is_relative_to(REPO / "build")


def test_native_pgm_matches_fallback_and_jax():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (95, 123), dtype=np.uint8)
    data = tnative.pgm_encode(img)
    assert data == fallback(tnative.pgm_encode, img) == jnative.pgm_encode(img)
    assert np.array_equal(tnative.pgm_decode(data), img)
    assert np.array_equal(fallback(tnative.pgm_decode, data), img)
    with pytest.raises(ValueError):
        tnative.pgm_decode(b"JUNKDATA")


def test_native_velodyne_matches_fallback():
    rng = np.random.RandomState(1)
    n = 500
    rec = np.zeros((n, 8), np.uint8)
    rec[:, :6] = rng.randint(0, 65536, (n, 3)).astype("<u2").view(
        np.uint8).reshape(n, 6)
    rec[:, 6] = rng.randint(0, 255, n)
    raw = rec.tobytes()
    x_nat, i_nat = tnative.velodyne_unpack(raw)
    x_py, i_py = fallback(tnative.velodyne_unpack, raw)
    np.testing.assert_allclose(x_nat, x_py, rtol=0, atol=2e-5)
    assert np.array_equal(i_nat, i_py)
    x_j, i_j = jnative.velodyne_unpack(raw)
    assert np.array_equal(x_nat, x_j) and np.array_equal(i_nat, i_j)


def test_native_bresenham_matches_fallback():
    rng = np.random.RandomState(2)
    rows, cols = 64, 80
    r1s = rng.randint(0, rows, 40)
    c1s = rng.randint(0, cols, 40)
    g_nat = tnative.bresenham_update(np.zeros((rows, cols), np.float32),
                                     32, 40, r1s, c1s)
    g_py = fallback(tnative.bresenham_update,
                    np.zeros((rows, cols), np.float32), 32, 40, r1s, c1s)
    np.testing.assert_allclose(g_nat, g_py, rtol=0, atol=1e-6)
    assert (g_nat > 0).sum() > 0 and (g_nat < 0).sum() > 40


def test_native_csv_matches_fallback():
    text = ("ts,x,y\n" + "\n".join(
        f"{i * 0.1:.3f},{i * 2.0:.2f},{-i:.1f}" for i in range(50))).encode()
    a = tnative.csv_parse_floats(text, 3)
    b = fallback(tnative.csv_parse_floats, text, 3)
    assert a.shape == (50, 3) and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------

def test_checkpoint_round_trips_every_node(tmp_path):
    tree = {
        "store": port_store(random_store()),
        "grid": torch.randint(0, 3, (2, 5, 7), dtype=torch.int8),
        "pair": (torch.arange(3), [torch.ones(2, dtype=torch.bool), None]),
        "meta": {"n": 3, "x": 1.5, "name": "a", "flag": True},
    }
    p = tart.save_checkpoint(tree, tmp_path / "teach_state.ckpt")
    assert p == tmp_path / "teach_state.ckpt" and p.is_file()
    back = tart.load_checkpoint(p, "cpu")
    assert type(back["store"]) is TStore
    for a, b in zip(tree["store"], back["store"]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert back["grid"].dtype == torch.int8
    assert torch.equal(back["grid"], tree["grid"])
    assert isinstance(back["pair"], tuple) and isinstance(back["pair"][1],
                                                          list)
    assert torch.equal(back["pair"][0], tree["pair"][0])
    assert back["pair"][1][1] is None and back["meta"] == tree["meta"]
    with pytest.raises(TypeError):
        tart.save_checkpoint({"x": object()}, tmp_path / "bad.ckpt")


@pytest.mark.parametrize("kind", ["function", "fields", "class"])
def test_checkpoint_refuses_a_crafted_type(tmp_path, kind):
    """A structure spec that names anything but a NamedTuple of the package
    with exactly its fields raises before the name is called: a package
    function named with keyword arguments from the file is never run."""
    victim = tmp_path / "written_by_checkpoint.ckpt"
    typ, items = {
        "function": ("nclt_slam_tpu_torch.io.artifacts.save_checkpoint",
                     {"tree": {"t": "value", "v": 1},
                      "path": {"t": "value", "v": str(victim)}}),
        "fields": (f"{TStore.__module__}.{TStore.__qualname__}",
                   {"pos": {"t": "value", "v": 0}}),
        "class": ("nclt_slam_tpu_torch.io.artifacts.Path",
                  {"x": {"t": "value", "v": str(victim)}}),
    }[kind]
    meta = {"format": tart.CHECKPOINT_FORMAT,
            "tree": {"t": "namedtuple", "type": typ, "items": items}}
    path = tmp_path / "teach_state.ckpt"
    with open(path, "wb") as f:
        np.savez(f, __spec__=np.array(json.dumps(meta)))
    with pytest.raises(ValueError, match="not a NamedTuple"):
        tart.load_checkpoint(path, "cpu")
    assert not victim.exists()


def test_checkpoint_resume_exact(tmp_path):
    """Mid-rollout checkpoint of an ours repeat carry -> resume continues
    bit-exactly (the port's counterpart of
    tests/test_rollout_e2e.py::test_checkpoint_resume_exact)."""
    from nclt_slam_tpu_torch.cli.common import config_for
    from nclt_slam_tpu_torch.landmarks.store import init_store
    from nclt_slam_tpu_torch.rollout import campaign
    from nclt_slam_tpu_torch.rollout.repeat import init_repeat_carry, repeat_step

    cfg = config_for("ours", 0.25)
    data = campaign.build_campaign(["08_nw_sw"], cfg=cfg, device="cpu")
    store = init_store(cfg.landmarks, 1, "cpu")
    grid = torch.ones(1, cfg.map.rows, cfg.map.cols, dtype=torch.int8)

    def step(c, t):
        return repeat_step(c, t, data.scenes_repeat, data.routes, grid,
                           store, cfg)

    carry = init_repeat_carry(data.routes, data.routes.wps,
                              data.routes.n_wps, cfg)
    for t in range(6):
        carry, _ = step(carry, t)
    ckpt = tart.save_checkpoint(carry, tmp_path / "carry.ckpt")
    carry_a, carry_b = carry, tart.load_checkpoint(ckpt, "cpu")
    assert type(carry_b) is type(carry)
    for t in range(6, 12):
        carry_a, tr_a = step(carry_a, t)
        carry_b, tr_b = step(carry_b, t)
        for x, y in zip(tr_a, tr_b):
            assert torch.equal(x, y)

    def leaves(tree):
        if isinstance(tree, tuple):
            return [x for sub in tree for x in leaves(sub)]
        return [tree]

    la, lb = leaves(carry_a), leaves(carry_b)
    assert len(la) == len(lb) > 50
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_jax_checkpoint_refused_without_jax(tmp_path):
    """A JAX checkpoint (a pickled tree definition) is refused in a fresh
    interpreter, which never imports JAX to do so."""
    p = jart.save_checkpoint({"grid": jnp.zeros((3, 4), jnp.int8)},
                             tmp_path / "teach_state.ckpt")
    code = (
        "import sys\n"
        "from nclt_slam_tpu_torch.io import load_checkpoint\n"
        "try:\n"
        f"    load_checkpoint({str(p)!r}, 'cpu')\n"
        "except ValueError as e:\n"
        "    assert 'JAX' in str(e), e\n"
        "else:\n"
        "    raise SystemExit('a JAX checkpoint was loaded')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'nclt_slam_tpu'))\n"
        "assert not bad, bad\n"
        "print('refused')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "refused"
