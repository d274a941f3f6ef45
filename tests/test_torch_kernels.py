"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.  This file imports neither JAX nor the JAX package,
so it also runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda

Without a CUDA device every test here skips (a kernel has no CPU mode).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nclt_slam_tpu_torch.ops import wavefront as ops

# the BA problem generators live in the smoke script at the repository's root
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

BIG = 1e9


def _grids(rng, B, H, W):
    tc = rng.uniform(0.1, 2.0, (B, H, W)).astype(np.float32)
    tc[rng.rand(B, H, W) < 0.15] = BIG
    phi0 = np.full((B, H, W), BIG, np.float32)
    phi0[np.arange(B), rng.randint(0, H, B), rng.randint(0, W, B)] = 0.0
    return torch.from_numpy(tc), torch.from_numpy(phi0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


# the planner's two shapes; H < 8 (empty bands: (1, 1, 5), (2, 5, 9));
# uneven bands (119 = 7 * 15 + 14, 37 = 7 * 5 + 2); n_iter not a multiple
# of the halo depth (70, 11, 9, 383); the widest grid the first kernel took
# at its full height (1, 54, 1024), where shared memory cuts the halo
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(15, 192, 192, 384), (15, 119, 232, 384),
                                   (2, 37, 53, 70), (1, 1, 5, 3),
                                   (2, 5, 9, 11), (3, 119, 232, 383),
                                   (1, 54, 1024, 9), (2, 7, 300, 20),
                                   (1, 2000, 30, 50)])
def test_wavefront_kernel_equals_plain(cuda, shape):
    B, H, W, n_iter = shape
    tc, phi0 = _grids(np.random.RandomState(H * W), B, H, W)
    tc, phi0 = tc.to(cuda), phi0.to(cuda)
    before = ops.wavefront_relax.launches
    got = ops.wavefront_relax(tc, phi0, n_iter)
    torch.cuda.synchronize()
    assert ops.wavefront_relax.launches == before + 1
    assert torch.equal(got, ops.wavefront_relax_plain(tc, phi0, n_iter))


@pytest.mark.cuda
def test_wavefront_kernel_repeated_launches(cuda):
    # a race in the halo exchange would show as an occasional difference
    tc, phi0 = _grids(np.random.RandomState(7), 15, 192, 192)
    tc, phi0 = tc.to(cuda), phi0.to(cuda)
    ref = ops.wavefront_relax_plain(tc, phi0, 384)
    outs = [ops.wavefront_relax(tc, phi0, 384) for _ in range(20)]
    torch.cuda.synchronize()
    assert [i for i, o in enumerate(outs) if not torch.equal(o, ref)] == []


@pytest.mark.cuda
def test_wavefront_kernel_rejects_unsupported_shape(cuda):
    x = torch.zeros(1, 8, 2048, device=cuda)
    with pytest.raises(ValueError):
        ops.wavefront_relax(x, x, 4)


def _descriptors(rng, P, A, W=8):
    d = rng.randint(0, 2 ** 32, (P, A, W), dtype=np.uint64).astype(np.int64)
    return torch.from_numpy(d)


def _hamming_case(shape):
    """(da, va, db, vb) on the CPU at (P, A, B, group): random words, b rows
    shared with and one bit off the a rows (ties and matches), ~20 %
    invalid rows and, where P > 1, an all-invalid problem."""
    P, A, B, group = shape
    rng = np.random.RandomState(P * A + B)
    da = _descriptors(rng, P, A)
    db = _descriptors(rng, P // group, B)
    n = max(1, min(A, B) // 2)
    db[:, :n] = da[::group, :n]
    db[:, n:n + n // 2] = da[::group, n:n + n // 2] ^ 1
    va = torch.from_numpy(rng.rand(P, A) > 0.2)
    vb = torch.from_numpy(rng.rand(P // group, B) > 0.2)
    if P > 1:
        va[0] = False                               # an all-invalid problem
    return da, va, db, vb


# the main path's two shapes; the first kernel's test shapes; then each
# edge of the plan: one row and one column (1, 1, 1); bands off the 32-row
# chunk and columns off the 8-column tile, a group of 3 (6, 17, 9, 3: C =
# 4); a last band shorter than the others (3, 7, 5: C = 4, bands of 2, 2,
# 2 and 1); more clusters than one wave (200, 40, 70: 200 clusters of 8);
# B > 512 (2, 9, 700); the int32 limit, with more than 48 KB of shared
# memory (1, 2146, 2146)
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(15, 256, 384, 1), (75, 256, 256, 5),
                                   (3, 7, 5, 1), (4, 1000, 300, 2),
                                   (2, 33, 65, 1), (1, 1, 1, 1),
                                   (6, 17, 9, 3), (200, 40, 70, 1),
                                   (2, 9, 700, 1), (1, 2146, 2146, 1)])
def test_hamming_kernel_equals_plain(cuda, shape):
    from nclt_slam_tpu_torch.ops import hamming as hm

    da, va, db, vb = _hamming_case(shape)
    ref = hm.cross_check_plain(da, va, db, vb)
    before = hm.cross_check.launches
    got = hm.cross_check(*(t.to(cuda) for t in (da, va, db, vb)),
                         site="test")
    torch.cuda.synchronize()
    assert hm.cross_check.launches == before + 1
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)
    assert ref[1].any()


# the RGB-D SLAM baseline's two calls on its loop session: 139 odometry
# frame pairs and 16 loop candidates, 256 live features a frame
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(139, 256, 256, 1), (16, 256, 256, 1)])
def test_hamming_kernel_at_rgbd_slam_shapes(cuda, shape):
    from nclt_slam_tpu_torch.ops import hamming as hm

    da, va, db, vb = _hamming_case(shape)
    ref = hm.cross_check_plain(da, va, db, vb)
    before = hm.cross_check.site_launches.get("rgbd_slam", 0)
    got = hm.cross_check(*(t.to(cuda) for t in (da, va, db, vb)),
                         site="rgbd_slam")
    torch.cuda.synchronize()
    assert hm.cross_check.site_launches["rgbd_slam"] == before + 1
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)
    assert ref[1].any()


@pytest.mark.cuda
def test_rgbd_slam_batched_frame_rel_pose_equals_per_pair(cuda):
    """``frame_rel_pose`` of 39 odometry pairs of the loop session in one
    batched call on the card against the same pairs one call each.  cuBLAS
    picks its batched products by batch size, so the sums round
    differently, and where two Kabsch starts tie below float32 resolution
    the start kept follows that rounding.  So each result, batched or not,
    must be a tied start's (``chip_smoke.kabsch_ties``, float64 on the
    card): its count, and its pose within ``KABSCH_TIE_POSE_ATOL`` (1e-5)
    of that start's float64 pose; the two counts differ by one inlier at
    most, on at most a tenth of the pairs, and the flags agree wherever the
    counts do."""
    import chip_smoke
    from nclt_slam_tpu_torch.config import DEFAULT
    from nclt_slam_tpu_torch.datasets.slam import rgbd_slam as rs

    obs, _ = chip_smoke.rgbd_loop_session(cuda, T=40)
    cam = DEFAULT.camera
    ties = chip_smoke.kabsch_ties(obs, cam)
    batched = rs.frame_rel_pose(rs._frames(obs, range(39)),
                                rs._frames(obs, range(1, 40)), cam)
    flips = 0
    for p in range(39):
        one = rs.frame_rel_pose(rs._frames(obs, [p]),
                                rs._frames(obs, [p + 1]), cam)
        for r, q in ((batched, p), (one, 0)):
            pose = [x[q].item() for x in r[:3]]
            assert chip_smoke.tie_witnessed(ties[p], r[3][q], pose), \
                (p, int(r[3][q]), pose, ties[p])
        dn = abs(int(batched[3][p]) - int(one[3][0]))
        assert dn <= 1, p
        flips += dn
        if not dn:
            assert bool(batched[4][p]) == bool(one[4][0]), p
    assert flips <= 0.1 * 39


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", [(15, 256, 384, 1), (75, 256, 256, 5),
                                   (2, 57, 65, 1)])
def test_hamming_kernel_every_cluster_size(cuda, shape, cluster):
    from nclt_slam_tpu_torch.ops import hamming as hm

    da, va, db, vb = _hamming_case(shape)
    ref = hm.cross_check_plain(da, va, db, vb)
    P, A, B, _ = shape
    plan = hm.plan(P, A, B, cluster=cluster)
    assert plan.cluster == cluster
    got = hm.launch(*(t.to(cuda) for t in (da, va, db, vb)), 64, plan)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)


@pytest.mark.cuda
def test_hamming_kernel_repeated_launches(cuda):
    # a race in the cluster merge would show as an occasional difference
    from nclt_slam_tpu_torch.ops import hamming as hm

    args = [t.to(cuda) for t in _hamming_case((15, 256, 384, 1))]
    ref = hm.cross_check_plain(*args)
    outs = [hm.cross_check(*args, site="test") for _ in range(20)]
    torch.cuda.synchronize()
    assert [i for i, out in enumerate(outs)
            if not all(torch.equal(o, r) for o, r in zip(out, ref))] == []


@pytest.mark.cuda
def test_hamming_kernel_rejects_unsupported(cuda):
    from nclt_slam_tpu_torch.ops import hamming as hm

    v = torch.ones(1, 4, dtype=torch.bool, device=cuda)
    for words in (4, 9):                  # the kernel takes 8 words
        d = torch.zeros(1, 4, words, dtype=torch.int64, device=cuda)
        with pytest.raises(ValueError):
            hm.cross_check(d, v, d, v)


# K3 against its plain version on consistent windows (B, K, P, iters, point
# prior, w_rel).  Both solve the reduced system by an unpivoted Cholesky;
# they differ in summation order only, so they agree by the tolerances of
# the JAX package's tests/test_ba_pallas.py: poses 2e-4 m, quaternions
# 2e-5, points 1e-3 m, cost 1e-3 relative.
BA_SHAPES = [(3, 6, 64, 10, None, 100.0), (1, 6, 40, 6, 50.0, 100.0),
             (2, 10, 48, 6, None, 100.0), (15, 16, 192, 3, 50.0, 10.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BA_SHAPES)
def test_ba_kernel_matches_plain(cuda, shape):
    from nclt_slam_tpu_torch import config
    from nclt_slam_tpu_torch.ops import ba as ops_ba
    from nclt_slam_tpu_torch.vio import ba
    from chip_smoke import consistent_windows

    B, K, P, iters, prior, w_rel = shape
    cfg = config.DEFAULT
    prob, _ = consistent_windows(range(B), cuda, K=K, P=P, w_rel=w_rel,
                                 prior=prior)
    before = ops_ba.solve_ba_cuda.launches
    got = ba.solve_ba(prob, cfg.camera, cfg.vio, iters=iters, site="test")
    again = ba.solve_ba(prob, cfg.camera, cfg.vio, iters=iters, site="test")
    torch.cuda.synchronize()
    assert ops_ba.solve_ba_cuda.launches == before + 2
    ref = ba.solve_ba_plain(prob, cfg.camera, cfg.vio, iters=iters)
    for f, tol in (("kf_pos", 2e-4), ("kf_quat", 2e-5), ("points", 1e-3)):
        assert (getattr(got, f) - getattr(ref, f)).abs().max().item() <= tol, f
    torch.testing.assert_close(got.final_cost, ref.final_cost, rtol=1e-3,
                               atol=0.0)
    # fixed summation order, no atomics: a run repeats bit for bit
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_ba_kernel_rejects_unsupported(cuda):
    from nclt_slam_tpu_torch import config
    from nclt_slam_tpu_torch.vio import ba
    from chip_smoke import bench_windows

    cfg = config.DEFAULT
    # a 40-keyframe reduced system (240 x 241 floats) is beyond one block's
    # shared memory
    with pytest.raises(ValueError):
        ba.solve_ba(bench_windows(1, 40, 64, cuda), cfg.camera, cfg.vio)
    prob = bench_windows(1, 6, 32, cuda)
    with pytest.raises(TypeError):
        ba.solve_ba(prob._replace(obs_z=prob.obs_z.double()), cfg.camera,
                    cfg.vio)
    with pytest.raises(ValueError):
        ba.solve_ba(prob._replace(obs_w=prob.obs_w[:, :, :-1]), cfg.camera,
                    cfg.vio)


def _ba_within(got, ref):
    for f, tol in (("kf_pos", 2e-4), ("kf_quat", 2e-5), ("points", 1e-3)):
        assert (getattr(got, f) - getattr(ref, f)).abs().max().item() <= tol, f
    torch.testing.assert_close(got.final_cost, ref.final_cost, rtol=1e-3,
                               atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_ba_kernel_every_cluster_size(cuda, cluster):
    """The rollout's call under every cluster size: within tolerance of the
    plain version, two launches bit-equal, and the plan's shared memory
    the kernel's own count."""
    from nclt_slam_tpu_torch import config
    from nclt_slam_tpu_torch.ops import ba as ops_ba
    from nclt_slam_tpu_torch.vio import ba
    from chip_smoke import consistent_windows

    B, K, P, iters, prior, w_rel = BA_SHAPES[-1]
    cfg = config.DEFAULT
    prob, _ = consistent_windows(range(B), cuda, K=K, P=P, w_rel=w_rel,
                                 prior=prior)
    plan = ops_ba.plan(B, K, P, cluster=cluster)
    assert plan.cluster == cluster
    assert ops_ba.kernel_smem_bytes(plan, K) == plan.smem_bytes
    assert ops_ba.max_active_clusters(plan) >= 1
    got = ops_ba.launch(prob, cfg.camera, cfg.vio, iters, plan)
    again = ops_ba.launch(prob, cfg.camera, cfg.vio, iters, plan)
    torch.cuda.synchronize()
    _ba_within(got, ba.solve_ba_plain(prob, cfg.camera, cfg.vio, iters=iters))
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_ba_kernel_largest_window_against_float64(cuda):
    """The sweep's widest window (24 keyframes, 512 landmarks: each rank's
    slice in four chunks, formed again for the back-substitution, rows of
    the exchange in two halves) on consistent windows, within the
    tolerances of a float64 solve.  Printed beside it: the plain version
    in float32, which sums all 512 landmarks of a block at once."""
    from nclt_slam_tpu_torch import config
    from nclt_slam_tpu_torch.ops import ba as ops_ba
    from nclt_slam_tpu_torch.vio import ba
    from chip_smoke import consistent_windows

    cfg = config.DEFAULT
    prob, _ = consistent_windows(range(2), cuda, K=24, P=512)
    plan = ops_ba.plan(2, 24, 512)
    assert plan.kept < plan.landmarks_per_rank
    got = ba.solve_ba(prob, cfg.camera, cfg.vio, iters=8, site="test")
    p64 = ba.BAProblem(*(t.double() if torch.is_tensor(t) else t
                         for t in prob))
    ref = ba.solve_ba_plain(p64, cfg.camera, cfg.vio, iters=8)
    plain = ba.solve_ba_plain(prob, cfg.camera, cfg.vio, iters=8)
    torch.cuda.synchronize()
    for name, out in (("kernel", got), ("plain float32", plain)):
        err = {f: (getattr(out, f).double() - getattr(ref, f)).abs().max()
               .item() for f in ("kf_pos", "kf_quat", "points")}
        print(f"{name} against float64: {err}")
    for f, tol in (("kf_pos", 2e-4), ("kf_quat", 2e-5), ("points", 1e-3)):
        assert (getattr(got, f).double() - getattr(ref, f)).abs().max() \
            .item() <= tol, f


@pytest.mark.cuda
def test_ba_kernel_nan_window_stays_alone(cuda):
    """A window of NaN observations beside finite ones: the finite windows
    equal their solves alone, bit for bit (the plan is the same: one
    cluster a window), and the NaN window keeps its poses."""
    from nclt_slam_tpu_torch import config
    from nclt_slam_tpu_torch.vio import ba
    from chip_smoke import consistent_windows

    cfg = config.DEFAULT
    prob, _ = consistent_windows(range(3), cuda, K=6, P=64)
    bad = prob._replace(obs_uv=prob.obs_uv.clone())
    bad.obs_uv[1] = float("nan")
    got = ba.solve_ba(bad, cfg.camera, cfg.vio, iters=3, site="test")
    for i in (0, 2):
        one = ba.BAProblem(*(t[i:i + 1] if torch.is_tensor(t) else t
                             for t in prob))
        alone = ba.solve_ba(one, cfg.camera, cfg.vio, iters=3, site="test")
        for a, b in zip(got, alone):
            assert torch.equal(a[i:i + 1], b)
    torch.cuda.synchronize()
    assert torch.equal(got.kf_pos[1], prob.kf_pos[1])
    assert not torch.isfinite(got.final_cost[1])


# K4 against its plain version on chip_smoke.py's four check graphs (the
# JAX package's two-lap test graph reduced; the fused route's padded graph
# at the SLAM tool's shape, 130 poses and 64 loop slots; a graph with no
# valid loop; the padded graph of a 2000-pose session with 256 loop slots,
# 514 poses): within 1e-3 (the float32 blocked Cholesky without pivoting
# against a pivoted LU, in float32 and float64).
@pytest.mark.cuda
@pytest.mark.parametrize("name", ["two_lap", "tool_shape", "no_valid_loop",
                                  "large"])
def test_pgo_kernel_matches_plain(cuda, name):
    from nclt_slam_tpu_torch.datasets.slam import loop_closure as lc
    from nclt_slam_tpu_torch.ops import pgo as ops_pgo
    from chip_smoke import PGO_ATOL, pgo_graphs

    graph, w = pgo_graphs(cuda)[name]
    before = ops_pgo.optimize_pgo_cuda.launches
    got = lc.optimize_pgo(graph, w, iters=15, site="test")
    again = lc.optimize_pgo(graph, w, iters=15, site="test")
    torch.cuda.synchronize()
    assert ops_pgo.optimize_pgo_cuda.launches == before + 2
    assert torch.isfinite(got).all()
    # fixed summation order, no atomics: a run repeats bit for bit
    assert torch.equal(got, again)
    ref = lc.optimize_pgo_plain(graph, w, iters=15)
    assert (got - ref).abs().max().item() <= PGO_ATOL
    g64 = graph._replace(poses=graph.poses.double(),
                         odo_meas=graph.odo_meas.double(),
                         loop_meas=graph.loop_meas.double())
    ref64 = lc.optimize_pgo_plain(g64, w.double(), iters=15)
    assert (got.double() - ref64).abs().max().item() <= PGO_ATOL


@pytest.mark.cuda
def test_pgo_kernel_launched_once_by_fused_route(cuda):
    from nclt_slam_tpu_torch.datasets.slam import loop_closure as lc
    from nclt_slam_tpu_torch.ops import pgo as ops_pgo
    from chip_smoke import two_lap_graph

    graph = lc.PoseGraph2D(*(torch.from_numpy(a).to(cuda)
                             for a in two_lap_graph()[0]))
    ops_pgo.reset_launches()
    fused = lc.optimize_pose_graph_fast(graph, iters=15)
    host = lc.optimize_pose_graph_fast(graph, iters=15, backend="xla")
    torch.cuda.synchronize()
    assert ops_pgo.optimize_pgo_cuda.site_launches == {"fused": 1, "host": 1}
    assert fused.device.type == "cuda" and torch.isfinite(fused).all()
    # the padded copies of the last pose are extra damped unknowns: the two
    # routes differ transiently, as tests/test_pgo.py allows (0.1)
    assert (fused - host).abs().max().item() < 0.1


@pytest.mark.cuda
def test_pgo_kernel_rejects_unsupported(cuda):
    from nclt_slam_tpu_torch.datasets.slam import loop_closure as lc
    from chip_smoke import pgo_graphs

    graph, w = pgo_graphs(cuda)["two_lap"]
    with pytest.raises(TypeError):
        lc.optimize_pgo(graph._replace(poses=graph.poses.double()), w)
    with pytest.raises(ValueError):
        lc.optimize_pgo(graph._replace(odo_meas=graph.odo_meas[:-1]), w)
