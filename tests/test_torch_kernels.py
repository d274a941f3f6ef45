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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(15, 192, 192, 384), (15, 119, 232, 384),
                                   (2, 37, 53, 70), (1, 1, 5, 3)])
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
def test_wavefront_kernel_rejects_unsupported_shape(cuda):
    x = torch.zeros(1, 8, 2048, device=cuda)
    with pytest.raises(ValueError):
        ops.wavefront_relax(x, x, 4)


def _descriptors(rng, P, A, W=8):
    d = rng.randint(0, 2 ** 32, (P, A, W), dtype=np.uint64).astype(np.int64)
    return torch.from_numpy(d)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(15, 256, 384, 1), (75, 256, 256, 5),
                                   (3, 7, 5, 1), (4, 1000, 300, 2),
                                   (2, 33, 65, 1)])
def test_hamming_kernel_equals_plain(cuda, shape):
    from nclt_slam_tpu_torch.ops import hamming as hm

    P, A, B, group = shape
    rng = np.random.RandomState(P * A + B)
    da = _descriptors(rng, P, A)
    db = _descriptors(rng, P // group, B)
    # shared and near-shared rows so that ties and matches occur
    n = min(A, B) // 2
    db[:, :n] = da[::group, :n]
    db[:, n:n + n // 2] = da[::group, n:n + n // 2] ^ 1
    va = torch.from_numpy(rng.rand(P, A) > 0.2)
    vb = torch.from_numpy(rng.rand(P // group, B) > 0.2)
    va[0] = False                                   # an all-invalid problem
    ref = hm.cross_check_plain(da, va, db, vb)
    before = hm.cross_check.launches
    got = hm.cross_check(*(t.to(cuda) for t in (da, va, db, vb)),
                         site="test")
    torch.cuda.synchronize()
    assert hm.cross_check.launches == before + 1
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)
    assert ref[1].any()


@pytest.mark.cuda
def test_hamming_kernel_rejects_unsupported(cuda):
    from nclt_slam_tpu_torch.ops import hamming as hm

    v = torch.ones(1, 4, dtype=torch.bool, device=cuda)
    for words in (4, 9):                  # the kernel takes 8 words
        d = torch.zeros(1, 4, words, dtype=torch.int64, device=cuda)
        with pytest.raises(ValueError):
            hm.cross_check(d, v, d, v)


# K3 against its plain version on consistent windows (B, K, P, iters, point
# prior, w_rel).  The two differ in the reduced solve (Gauss-Jordan against
# Cholesky) and in summation order, so they agree by the tolerances of the
# JAX package's tests/test_ba_pallas.py: poses 2e-4 m, quaternions 2e-5,
# points 1e-3 m, cost 1e-3 relative.
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
