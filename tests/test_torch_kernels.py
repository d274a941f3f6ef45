"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.  This file imports neither JAX nor the JAX package,
so it also runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda

Without a CUDA device every test here skips (a kernel has no CPU mode).
"""

import numpy as np
import pytest
import torch

from nclt_slam_tpu_torch.ops import wavefront as ops

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
