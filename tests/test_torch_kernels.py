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
