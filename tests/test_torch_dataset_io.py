"""The port's dataset readers and dataset I/O against the JAX package's:
``datasets/{loaders,calibration}.py``, ``datasets/utils/{gps,imu_utils,
point_cloud}.py`` and ``io/{euroc,ins_imu,rover}.py``.

Tolerances: the numpy modules are copies, so their files are byte-equal and
their arrays equal.  The tensor functions: ``voxel_downsample`` exactly
equal (integer hash, stable sort, the shared slot's winner);
``imu_preintegration`` / ``integrate_gyro`` equal where every dt is 0 and
within 1e-5 (positions 1e-5 m) on short relative timestamps (float32
rounding of XLA's fused multiply-adds over 200 steps); ``estimate_normals_knn``
within 1e-5 up to the sign of a normal with n_z = 0; ``remap_bilinear``
within 1e-5.
"""

import filecmp
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nclt_slam_tpu.datasets import calibration as jcal
from nclt_slam_tpu.datasets import loaders as jld
from nclt_slam_tpu.datasets.utils import gps as jgps
from nclt_slam_tpu.datasets.utils import imu_utils as jimu
from nclt_slam_tpu.datasets.utils import point_cloud as jpc
from nclt_slam_tpu.io import euroc as jeuroc
from nclt_slam_tpu.io import ins_imu as jins
from nclt_slam_tpu.io import rover as jrover
from nclt_slam_tpu_torch.datasets import calibration as tcal
from nclt_slam_tpu_torch.datasets import loaders as tld
from nclt_slam_tpu_torch.datasets.utils import gps as tgps
from nclt_slam_tpu_torch.datasets.utils import imu_utils as timu
from nclt_slam_tpu_torch.datasets.utils import point_cloud as tpc
from nclt_slam_tpu_torch.io import euroc as teuroc
from nclt_slam_tpu_torch.io import ins_imu as tins
from nclt_slam_tpu_torch.io import rover as trover

torch.set_num_threads(1)


def same_tree(a: Path, b: Path):
    fa = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    fb = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert fa == fb and fa
    for f in fa:
        assert filecmp.cmp(a / f, b / f, shallow=False), f


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    root = tmp_path_factory.mktemp("mock")
    jd = jld.generate_mock_session(root / "jax", duration_s=10.0)
    td = tld.generate_mock_session(root / "torch", duration_s=10.0)
    return Path(jd), Path(td)


def test_mock_session_files_byte_equal(sessions):
    same_tree(*sessions)


def test_loaders_and_syncs_match_jax(sessions):
    jd, td = sessions
    js, ts = jld.Session(jd), tld.Session(td)
    assert sorted(js.streams) == sorted(ts.streams) and len(ts.streams) == 5
    for name in js.streams:
        assert np.array_equal(js[name].t_us, ts[name].t_us)
        assert np.array_equal(js[name].data, ts[name].data)
        assert ts[name].t_us.dtype == np.int64
    assert ts.t0_us == js.t0_us and "kvh" in ts
    jt, jsync = js.synced()
    tt, tsync = ts.synced()
    assert np.array_equal(jt, tt) and sorted(jsync) == sorted(tsync)
    for k in jsync:
        assert np.array_equal(jsync[k], tsync[k], equal_nan=True), k
    ref = ts["groundtruth"].t_us[::7] + 3_333
    for max_dt in (None, 5_000):
        for a, b in zip(jld.nearest_sync(ref, js["ms25"], max_dt),
                        tld.nearest_sync(ref, ts["ms25"], max_dt)):
            assert np.array_equal(a, b)
    assert np.array_equal(jld.interpolate_sync(ref, js["gps_rtk"]),
                          tld.interpolate_sync(ref, ts["gps_rtk"]))
    for loader in ("load_ms25", "load_gps_rtk", "load_odometry", "load_kvh",
                   "load_groundtruth"):
        assert callable(getattr(tld, loader))


def test_lidar_codecs_round_trip_with_jax(tmp_path):
    rng = np.random.RandomState(0)
    xyz = rng.uniform(-90, 90, (500, 3)).astype(np.float32)
    inten = rng.randint(0, 255, 500)
    tld.save_velodyne_bin(tmp_path / "t.bin", xyz, inten)
    jld.save_velodyne_bin(tmp_path / "j.bin", xyz, inten)
    assert filecmp.cmp(tmp_path / "t.bin", tmp_path / "j.bin", shallow=False)
    got = tld.load_velodyne_bin(tmp_path / "j.bin")
    assert np.array_equal(got, jld.load_velodyne_bin(tmp_path / "t.bin"))
    assert np.abs(got[:, :3] - xyz).max() <= 0.005
    t = 1_326_030_000_000_000 + np.arange(4) * 25_000
    ranges = rng.uniform(0.0, 35.0, (4, 1081)).astype(np.float32)
    tld.save_hokuyo_packets(tmp_path / "t.hok", t, ranges)
    jld.save_hokuyo_packets(tmp_path / "j.hok", t, ranges)
    assert filecmp.cmp(tmp_path / "t.hok", tmp_path / "j.hok", shallow=False)
    tt, tr = tld.load_hokuyo_packets(tmp_path / "j.hok")
    assert np.array_equal(tt, t) and np.array_equal(tr, ranges)
    for a, b in zip(tld.hokuyo_to_points(tr[1]),
                    jld.hokuyo_to_points(tr[1])):
        assert np.array_equal(a, b)


def test_calibration_and_gps_match_jax():
    jc, tc = jcal.Calibration(), tcal.Calibration()
    pts = np.random.RandomState(1).uniform(-5, 5, (50, 3))
    for s in jcal.DEFAULT_EXTRINSICS:
        assert np.array_equal(tc.body_from(s), jc.body_from(s))
        assert np.array_equal(tc.sensor_from_body(s), jc.sensor_from_body(s))
        assert np.array_equal(tc.transform_points(s, pts),
                              jc.transform_points(s, pts))
    assert np.array_equal(tc.between("velodyne", "lb3"),
                          jc.between("velodyne", "lb3"))
    # body<-sensor then sensor<-body is the identity
    back = tc.sensor_from_body("ms25") @ tc.body_from("ms25")
    np.testing.assert_allclose(back, np.eye(4), atol=1e-12)
    lat0, lon0, alt0 = np.deg2rad(42.293227), np.deg2rad(-83.709657), 270.0
    lat = lat0 + np.linspace(0, 1e-4, 9)
    lon = lon0 + np.linspace(0, -2e-4, 9)
    alt = np.full(9, 271.5)
    enu = tgps.lla_to_enu(lat, lon, alt, lat0, lon0, alt0)
    assert np.array_equal(enu, jgps.lla_to_enu(lat, lon, alt, lat0, lon0,
                                               alt0))
    assert np.array_equal(tgps.lla_to_ecef(lat, lon, alt),
                          jgps.lla_to_ecef(lat, lon, alt))
    np.testing.assert_allclose(enu[0], [0.0, 0.0, 1.5], atol=1e-6)


def test_imu_helpers_match_jax(sessions):
    ts = tld.Session(sessions[1])
    ms = ts["ms25"]
    for a, b in zip(timu.parse_ms25(ms.data), jimu.parse_ms25(ms.data)):
        assert np.array_equal(a, b)
    _, acc, gyr = timu.parse_ms25(ms.data)
    tgt = ts["groundtruth"].t_us
    for a, b in zip(timu.interpolate_imu(tgt, ms.t_us, acc, gyr),
                    jimu.interpolate_imu(tgt, ms.t_us, acc, gyr)):
        assert np.array_equal(a, b)
    still = np.arange(len(acc)) < 200
    for a, b in zip(timu.estimate_biases(acc, gyr, still),
                    jimu.estimate_biases(acc, gyr, still)):
        assert np.array_equal(a, b)
    for g in (acc.mean(0), np.array([0.0, 0.0, 9.8]),
              np.array([0.0, 0.0, -9.8])):
        assert np.array_equal(timu.gravity_align_rotation(g),
                              jimu.gravity_align_rotation(g))


def test_integrators_pin_the_zero_dt_quirk(sessions):
    """On the mock session's epoch-µs stamps the float32 cast collapses
    every stamp to one value: JAX's integrators return the initial state at
    every sample, and so do the port's."""
    ms = tld.Session(sessions[1])["ms25"]
    _, acc, gyr = timu.parse_ms25(ms.data)
    assert ms.t_us[0] > 10 ** 15 and len(ms.t_us) == 500
    t32 = ms.t_us.astype(np.float32)
    assert (np.diff(t32) == 0).all()
    jp = jimu.imu_preintegration(ms.t_us, acc, gyr)
    tp = timu.imu_preintegration(ms.t_us, acc, gyr)
    for k in ("positions", "velocities", "orientations"):
        assert tp[k].shape == jp[k].shape and tp[k].dtype == np.float32
        assert np.array_equal(tp[k], np.asarray(jp[k])), k
    assert not tp["positions"].any() and not tp["velocities"].any()
    assert np.array_equal(tp["orientations"],
                          np.broadcast_to(np.eye(3, dtype=np.float32),
                                          (500, 3, 3)))
    jr = jimu.integrate_gyro(ms.t_us, gyr)
    tr = timu.integrate_gyro(ms.t_us, gyr)
    assert np.array_equal(tr, np.asarray(jr))
    assert np.array_equal(tr, tp["orientations"])


def test_integrators_match_jax_on_relative_stamps():
    """Relative stamps (µs from 0, 50 Hz): dt = 0.02 s, a real motion."""
    rng = np.random.RandomState(4)
    n = 200
    t_us = np.arange(n, dtype=np.int64) * 20_000
    acc = np.column_stack([0.5 + rng.normal(0, 0.05, (n, 2)),
                           rng.normal(9.81, 0.05, n)])
    gyr = np.column_stack([rng.normal(0, 0.01, (n, 2)),
                           0.3 + rng.normal(0, 0.01, n)])
    jp = jimu.imu_preintegration(t_us, acc, gyr)
    tp = timu.imu_preintegration(t_us, acc, gyr)
    for k, atol in (("positions", 1e-5), ("velocities", 1e-5),
                    ("orientations", 1e-5)):
        np.testing.assert_allclose(tp[k], np.asarray(jp[k]), rtol=1e-5,
                                   atol=atol, err_msg=k)
    assert np.abs(tp["positions"][-1, :2]).max() > 1.0
    np.testing.assert_allclose(timu.integrate_gyro(t_us, gyr),
                               np.asarray(jimu.integrate_gyro(t_us, gyr)),
                               atol=1e-5)
    # tensors in, the same numbers out
    tq = timu.imu_preintegration(torch.from_numpy(t_us),
                                 torch.from_numpy(acc), torch.from_numpy(gyr))
    assert np.array_equal(tq["positions"], tp["positions"])


def cloud(rng, n, spread):
    pts = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    pts[n // 4: n // 2] = pts[: n // 4] + 0.01      # voxel duplicates
    valid = rng.rand(n) > 0.1
    return pts, valid


def voxel_both(pts, valid, voxel, out_cap, bound=200.0):
    jo, jv = jpc.voxel_downsample(jnp.asarray(pts), jnp.asarray(valid),
                                  voxel, out_cap, bound)
    to, tv = tpc.voxel_downsample(torch.from_numpy(pts),
                                  torch.from_numpy(valid), voxel, out_cap,
                                  bound)
    return (np.asarray(jo), np.asarray(jv)), (to.numpy(), tv.numpy())


@pytest.mark.parametrize("voxel,out_cap,spread", [
    (0.5, 512, 20.0),      # room for every voxel
    (0.5, 64, 20.0),       # more occupied voxels than out_cap
    (0.25, 512, 150.0),    # dims**3 > 2**31: the int32 hash wraps
])
def test_voxel_downsample_matches_jax(voxel, out_cap, spread):
    rng = np.random.RandomState(int(voxel * 100) + out_cap)
    pts, valid = cloud(rng, 400, spread)
    (jo, jv), (to, tv) = voxel_both(pts, valid, voxel, out_cap)
    assert np.array_equal(to, jo) and np.array_equal(tv, jv)
    dims = int(2 * 200.0 / voxel) + 1
    if dims ** 3 >= 2 ** 31:
        k = np.floor((pts + 200.0) / voxel).astype(np.int64)
        h64 = (k[:, 0] * dims + k[:, 1]) * dims + k[:, 2]
        h32 = h64.astype(np.int32)            # two's-complement wrap
        assert (h32 != h64).any()
        # a wrapped negative hash is dropped like an invalid point
        n_pos = len(np.unique(h32[valid & (h32 >= 0)]))
        assert tv.sum() == n_pos < len(np.unique(h64[valid]))
    else:
        assert tv.sum() == min(len(np.unique(
            np.floor((pts[valid] + 200.0) / voxel), axis=0)), out_cap)


def test_voxel_downsample_shared_slot_winner():
    """Pin XLA's winner at the shared slot ``out_cap - 1``: every dropped
    row and every kept row of rank >= out_cap - 1 writes it, and the last
    row of the stable hash order wins.  Here that row is a duplicate of
    the last voxel, so the slot is flagged valid and holds zeros."""
    pts = np.array([[0.1, 0.1, 0.1], [1.1, 0.1, 0.1], [2.1, 0.1, 0.1],
                    [3.1, 0.1, 0.1], [3.2, 0.1, 0.1]], np.float32)
    valid = np.ones(5, bool)
    (jo, jv), (to, tv) = voxel_both(pts, valid, 1.0, 2)
    assert np.array_equal(jv, [True, True]) and np.array_equal(jo[1], [0, 0, 0])
    assert np.array_equal(to, jo) and np.array_equal(tv, jv)
    # the same cloud without the duplicate: the last kept voxel wins
    (jo, jv), (to, tv) = voxel_both(pts[:4], valid[:4], 1.0, 2)
    assert np.array_equal(jo[1], pts[3])
    assert np.array_equal(to, jo) and np.array_equal(tv, jv)


def test_transform_and_crop_match_jax():
    rng = np.random.RandomState(3)
    pts = rng.uniform(-10, 10, (100, 3)).astype(np.float32)
    valid = rng.rand(100) > 0.2
    T = tcal.xyzrpy_to_matrix(1.0, -2.0, 0.5, 5.0, -3.0, 40.0,
                              degrees=True).astype(np.float32)
    np.testing.assert_allclose(
        tpc.transform_points(torch.from_numpy(pts), torch.from_numpy(T)),
        np.asarray(jpc.transform_points(jnp.asarray(pts), jnp.asarray(T))),
        atol=1e-5)
    lo, hi = (-5.0, -4.0, -3.0), (6.0, 5.0, 4.0)
    assert np.array_equal(
        tpc.crop_box(torch.from_numpy(pts), torch.from_numpy(valid), lo,
                     hi).numpy(),
        np.asarray(jpc.crop_box(jnp.asarray(pts), jnp.asarray(valid), lo,
                                hi)))


def test_estimate_normals_knn_matches_jax():
    rng = np.random.RandomState(6)
    # a tilted plane, a vertical wall (n_z = 0) and a duplicate point
    a = rng.uniform(-2, 2, (40, 2))
    plane = np.column_stack([a, 0.3 * a[:, 0] + 0.01 * rng.randn(40)])
    b = rng.uniform(-2, 2, (30, 2))
    wall = np.column_stack([np.full(30, 6.0), b])
    pts = np.concatenate([plane, wall, plane[:1]]).astype(np.float32)
    valid = np.ones(len(pts), bool)
    valid[5] = False
    jn = np.asarray(jpc.estimate_normals_knn(jnp.asarray(pts),
                                             jnp.asarray(valid), 8))
    tn = tpc.estimate_normals_knn(torch.from_numpy(pts),
                                  torch.from_numpy(valid), 8).numpy()
    flat = np.abs(jn[:, 2]) < 1e-4
    assert flat[40:70].all() and not flat[:40].any()
    np.testing.assert_allclose(tn[~flat], jn[~flat], atol=1e-5)
    # n_z = 0: the orientation rule leaves the library's sign
    s = np.sign((tn[flat] * jn[flat]).sum(-1, keepdims=True))
    np.testing.assert_allclose(tn[flat] * s, jn[flat], atol=1e-5)


def trajectory(n=60):
    t = np.arange(n) * 0.1
    yaw = 0.2 * t
    xyz = np.column_stack([np.cos(yaw) * 5, np.sin(yaw) * 5, 0.1 * t])
    quat = np.column_stack([np.zeros(n), np.zeros(n), np.sin(yaw / 2),
                            np.cos(yaw / 2)])
    rng = np.random.RandomState(8)
    return t, xyz, quat, rng.normal(0, 0.1, (n, 3)), rng.normal(0, 1, (n, 3))


def test_euroc_export_byte_equal_and_reader(tmp_path):
    t, xyz, quat, gyro, accel = trajectory()
    tr = teuroc.export_euroc(tmp_path / "t", t, xyz, quat, t, gyro, accel)
    jr = jeuroc.export_euroc(tmp_path / "j", t, xyz, quat, t, gyro, accel)
    same_tree(tmp_path / "t", tmp_path / "j")
    assert tr.name == jr.name == "mav0"
    for a, b in zip(teuroc.load_euroc_groundtruth(jr),
                    jeuroc.load_euroc_groundtruth(tr)):
        assert np.array_equal(a, b)
    ts, js = tins.load_euroc_session(tr), jins.load_euroc_session(jr)
    assert sorted(ts) == sorted(js)
    for k in ts:
        assert np.array_equal(ts[k], js[k]), k
    np.testing.assert_allclose(ts["xyz"], xyz, atol=1e-6)
    # without IMU: no imu0 directory, None in the session
    teuroc.export_euroc(tmp_path / "n", t, xyz, quat)
    assert tins.load_euroc_session(tmp_path / "n" / "mav0")["gyro"] is None


def test_ins_pseudo_imu_matches_jax():
    """The INS -> pseudo-IMU synthesis (numpy in both packages) within
    1e-6, and a constant yaw rate read back as the body z rate."""
    n = 300
    t = np.arange(n) * 0.01
    yaw = 0.4 * t
    vel = np.column_stack([np.cos(yaw), np.sin(yaw), np.zeros(n)]) * 2.0
    rpy = np.column_stack([np.full(n, 0.02), np.full(n, -0.01), yaw])
    got = tins.synthesize_imu_from_ins(t, vel, rpy)
    want = jins.synthesize_imu_from_ins(t, vel, rpy)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a, b, atol=1e-6)
    np.testing.assert_allclose(got[1][10:-10, 2], 0.4, atol=5e-3)
    np.testing.assert_allclose(
        tins.ned_to_body_rotation(*rpy[:3].T),
        jins.ned_to_body_rotation(*rpy[:3].T), atol=0)


def test_rover_association_matches_jax(tmp_path):
    rng = np.random.RandomState(9)
    rgb_t = np.sort(rng.uniform(0, 10, 80))
    depth_t = np.concatenate([rgb_t[::2] + rng.uniform(-0.004, 0.004, 40),
                              rng.uniform(0, 10, 20)])
    for a, b in zip(trover.associate_rgbd(rgb_t, depth_t),
                    jrover.associate_rgbd(rgb_t, depth_t)):
        assert np.array_equal(a, b) and a.dtype == b.dtype
    rf = [f"rgb/{i}.png" for i in range(80)]
    df = [f"depth/{i}.png" for i in range(60)]
    nt = trover.write_association(tmp_path / "t.txt", rgb_t, rf, depth_t, df)
    nj = jrover.write_association(tmp_path / "j.txt", rgb_t, rf, depth_t, df)
    assert nt == nj > 20
    assert filecmp.cmp(tmp_path / "t.txt", tmp_path / "j.txt", shallow=False)


def test_fisheye_maps_and_remap_match_jax():
    K_f = np.array([[280.0, 0, 320.0], [0, 281.0, 240.0], [0, 0, 1]])
    K_n = np.array([[200.0, 0, 160.0], [0, 200.0, 120.0], [0, 0, 1]])
    k4 = np.array([-0.01, 0.04, -0.03, 0.005])
    tm = trover.fisheye_rectify_maps(K_f, k4, K_n, (320, 240))
    jm = jrover.fisheye_rectify_maps(K_f, k4, K_n, (320, 240))
    for a, b in zip(tm, jm):
        assert np.array_equal(a, b) and a.dtype == np.float32
    rng = np.random.RandomState(10)
    for img in (rng.randint(0, 255, (480, 640)).astype(np.uint8),
                rng.rand(480, 640, 3).astype(np.float32)):
        # maps reaching past the image edge leave zeros
        mx, my = tm[0] * 1.6 - 100.0, tm[1]
        got = trover.remap_bilinear(torch.from_numpy(img),
                                    torch.from_numpy(mx),
                                    torch.from_numpy(my))
        want = np.asarray(jrover.remap_bilinear(img, mx, my))
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5,
                                   rtol=1e-6)
        assert (want == 0).any() and (want != 0).mean() > 0.5
