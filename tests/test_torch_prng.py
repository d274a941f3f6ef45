"""The port's threefry PRNG against jax.random, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nclt_slam_tpu_torch.core import prng

SEEDS = (0, 1, 7, 123456789)
SHAPES = ((), (3,), (7, 5), (4, 8, 32))


def _pair(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed, "cpu")


def _ulps(a, b):
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def test_partitionable_threefry_mode():
    # the port reproduces jax_threefry_partitionable=True; a JAX upgrade
    # that changes the default must fail here first
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_exact(seed):
    k, tk = _pair(seed)
    assert np.array_equal(np.asarray(k, np.int64), tk.numpy())
    for num in (2, 5, 20):
        assert np.array_equal(np.asarray(jax.random.split(k, num), np.int64),
                              prng.split(tk, num).numpy())
    for data in (0, 42, 2 ** 31 + 5):
        assert np.array_equal(
            np.asarray(jax.random.fold_in(k, data), np.int64),
            prng.fold_in(tk, data).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_bernoulli_exact(seed):
    k, tk = _pair(seed)
    for shape in SHAPES:
        assert np.array_equal(np.asarray(jax.random.bits(k, shape), np.int64),
                              prng.random_bits(tk, shape).numpy()), shape
        assert np.array_equal(np.asarray(jax.random.uniform(k, shape)),
                              prng.uniform(tk, shape).numpy()), shape
        assert np.array_equal(
            np.asarray(jax.random.uniform(k, shape, minval=0.5, maxval=1.6)),
            prng.uniform(tk, shape, 0.5, 1.6).numpy()), shape
        assert np.array_equal(
            np.asarray(jax.random.bernoulli(k, 0.055, shape)),
            prng.bernoulli(tk, 0.055, shape).numpy()), shape


def test_normal_within_four_ulps():
    # XLA's erfinv polynomial is reproduced, but XLA's log1p is not
    # torch's: a few percent of samples differ by up to a few ulps
    for seed in SEEDS:
        k, tk = _pair(seed)
        d = _ulps(jax.random.normal(k, (20000,)),
                  prng.normal(tk, (20000,)).numpy())
        assert d.max() <= 4, d.max()
        assert (d > 0).mean() < 0.05


def test_batched_keys_match_vmap():
    ks = jax.random.split(jax.random.PRNGKey(3), 4)
    tks = torch.from_numpy(np.asarray(ks, np.int64))
    want = jax.vmap(lambda k: jax.random.split(k, 20))(ks)
    assert np.array_equal(np.asarray(want, np.int64),
                          prng.split(tks, 20).numpy())
    p = np.random.RandomState(0).uniform(0, 1, (4, 50)).astype(np.float32)
    want = jax.vmap(lambda k, q: jax.random.bernoulli(k, q))(ks, p)
    assert np.array_equal(np.asarray(want),
                          prng.bernoulli(tks, torch.from_numpy(p)).numpy())
    want = jax.vmap(lambda k: jax.random.uniform(k, (6, 2), minval=-1.0,
                                                 maxval=3.0))(ks)
    assert np.array_equal(np.asarray(want),
                          prng.uniform(tks, (6, 2), -1.0, 3.0).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_exact(seed):
    """Every span 1..256 (the RANSAC pool sizes) plus wide spans whose
    2**32 % span multiplier wraps in uint32."""
    jk, tk = _pair(seed)
    spans = list(range(1, 257)) + [1000, 65535, 65536, 70001, 2 ** 31 - 1]
    for span in spans:
        want = np.asarray(jax.random.randint(jk, (7, 3), 0, span))
        got = prng.randint(tk, (7, 3), 0, span).numpy()
        assert np.array_equal(got, want), span
    want = np.asarray(jax.random.randint(jk, (5,), -3, 11))
    assert np.array_equal(prng.randint(tk, (5,), -3, 11).numpy(), want)
    # maxval <= minval returns minval
    assert (prng.randint(tk, (4,), 5, 5).numpy() == 5).all()


def test_randint_batched_keys_and_bounds():
    """One key and one upper bound per (route, candidate), as the matcher
    draws its RANSAC samples under vmap."""
    keys = jax.random.split(jax.random.PRNGKey(3), 12).reshape(3, 4, 2)
    mx = np.random.RandomState(0).randint(0, 257, (3, 4)).astype(np.int32)
    want = np.asarray(jax.vmap(jax.vmap(
        lambda k, m: jax.random.randint(k, (200, 3), 0, jnp.maximum(m, 1))))(
        keys, jnp.asarray(mx)))
    got = prng.randint(torch.from_numpy(np.asarray(keys).astype(np.int64)),
                       (200, 3), 0, torch.from_numpy(np.maximum(mx, 1)))
    assert np.array_equal(got.numpy(), want)
