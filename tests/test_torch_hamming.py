"""K1, the mutual-nearest-neighbour Hamming matcher: the port's plain
version (what a CPU tensor runs, and what the card's kernel is held to)
against the JAX package's Pallas kernel in interpret mode and its XLA path,
bit for bit, at ``tests/test_ops.py``'s shapes, a batch, and the main
path's two call-site shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nclt_slam_tpu.ops.hamming_pallas import cross_check_pallas
from nclt_slam_tpu.sensors import features as jfeat
from nclt_slam_tpu_torch.ops import hamming as thm
from nclt_slam_tpu_torch.sensors import features as tfeat

# the test workers share the CPU: one intra-op thread each keeps their
# torch thread pools from oversubscribing it
torch.set_num_threads(1)


def _problem(rng, A, B, W=8, shared=True):
    da = rng.randint(0, 2 ** 32, (A, W), dtype=np.uint64).astype(np.uint32)
    db = rng.randint(0, 2 ** 32, (B, W), dtype=np.uint64).astype(np.uint32)
    if shared:
        nsh = min(A, B) // 2
        db[:nsh] = da[rng.permutation(A)[:nsh]]
        # near-duplicates so that ties and close distances occur
        db[nsh:nsh + nsh // 2] = da[rng.permutation(A)[:nsh // 2]] ^ \
            np.uint32(1 << 5)
    va = rng.rand(A) > 0.2
    vb = rng.rand(B) > 0.2
    return da, va, db, vb


def _xla(da, va, db, vb):
    h = jfeat.hamming(jnp.asarray(da), jnp.asarray(db))
    h = jnp.where(jnp.asarray(va)[:, None] & jnp.asarray(vb)[None, :], h,
                  jnp.int32(10 ** 6))
    best_ab = jnp.argmin(h, axis=1)
    best_ba = jnp.argmin(h, axis=0)
    a = jnp.arange(h.shape[0])
    best_d = h[a, best_ab]
    return (np.asarray(best_ab), np.asarray((best_ba[best_ab] == a)
                                            & (best_d <= 64)),
            np.asarray(best_d))


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64)
                            if np.asarray(x).dtype == np.uint32
                            else np.asarray(x))


@pytest.mark.parametrize("shape", [(96, 192), (128, 96), (192, 384), (7, 5),
                                   (192, 192), (256, 384), (256, 256)])
def test_plain_matches_pallas_and_xla(shape):
    A, B = shape
    da, va, db, vb = _problem(np.random.RandomState(A * 1000 + B), A, B)
    ref = _xla(da, va, db, vb)
    pal = [np.asarray(x) for x in cross_check_pallas(
        jnp.asarray(da), jnp.asarray(va), jnp.asarray(db), jnp.asarray(vb),
        max_dist=64, interpret=True)]
    got = [x[0].numpy() for x in thm.cross_check(
        _t(da)[None], _t(va)[None], _t(db)[None], _t(vb)[None], 64)]
    for r, p, g, name in zip(ref, pal, got, ("best_b", "matched", "best_d")):
        assert np.array_equal(r, p), name
        assert np.array_equal(g.astype(r.dtype), r), name


def test_batch_and_groups_match_jax():
    """A (5, 96, 192) batch, an all-invalid problem, and the matcher's
    grouped form (five a-sets sharing one b-set)."""
    rng = np.random.RandomState(3)
    P, A, B = 5, 96, 192
    probs = [_problem(rng, A, B) for _ in range(P)]
    probs[2] = (probs[2][0], np.zeros(A, bool), probs[2][2], probs[2][3])
    da, va, db, vb = (np.stack(x) for x in zip(*probs))
    out = thm.cross_check(_t(da), _t(va), _t(db), _t(vb))
    for p in range(P):
        ref = _xla(da[p], va[p], db[p], vb[p])
        for r, g in zip(ref, out):
            assert np.array_equal(g[p].numpy().astype(r.dtype), r)
    assert not out[1][2].any() and (out[2][2] == thm.BIG).all()
    # grouped: problems 0..4 against b-set 0
    grouped = thm.cross_check(_t(da), _t(va), _t(db[:1]), _t(vb[:1]))
    for p in range(P):
        ref = _xla(da[p], va[p], db[0], vb[0])
        for r, g in zip(ref, grouped):
            assert np.array_equal(g[p].numpy().astype(r.dtype), r)


def test_cross_check_match_and_hamming_match_jax():
    rng = np.random.RandomState(0)
    d = rng.randint(0, 2 ** 32, (2, 8, 8), dtype=np.uint64).astype(np.uint32)
    h = thm.hamming_plain(_t(d), _t(d))
    for b in range(2):
        assert np.array_equal(h[b].numpy(), np.asarray(
            jfeat.hamming(jnp.asarray(d[b]), jnp.asarray(d[b]))))
    v = torch.ones(2, 8, dtype=torch.bool)
    m_idx, matched = tfeat.cross_check_match(_t(d), v, _t(d), v)
    assert matched.all() and (m_idx == torch.arange(8)).all()
    da, va, db, vb = _problem(rng, 64, 80)
    jm, jok, jd = jfeat.cross_check_match(
        jnp.asarray(da), jnp.asarray(va), jnp.asarray(db), jnp.asarray(vb),
        return_dist=True)
    tm, tok, td = tfeat.cross_check_match(_t(da)[None], _t(va)[None],
                                          _t(db)[None], _t(vb)[None],
                                          return_dist=True)
    assert np.array_equal(tm[0].numpy(), np.asarray(jm))
    assert np.array_equal(tok[0].numpy(), np.asarray(jok))
    assert np.array_equal(td[0].numpy(), np.asarray(jd))


def test_wrapper_checks():
    z = torch.zeros(2, 4, 8, dtype=torch.int64)
    v = torch.ones(2, 4, dtype=torch.bool)
    with pytest.raises(TypeError):
        thm.cross_check(z.int(), v, z, v)
    with pytest.raises(ValueError):
        thm.cross_check(z, v, z[:, :, :4], v)
    with pytest.raises(ValueError):      # 2 a-problems over 3 b-sets
        thm.cross_check(z, v, torch.zeros(3, 4, 8, dtype=torch.int64),
                        torch.ones(3, 4, dtype=torch.bool))
    big = torch.zeros(1, 3000, 8, dtype=torch.int64)
    vb = torch.ones(1, 3000, dtype=torch.bool)
    with pytest.raises(ValueError):      # keys overflow int32
        thm.cross_check(big, vb, big, vb)


def test_popcount_is_exact():
    x = torch.tensor([0, 1, 0xFFFFFFFF, 0x80000000, 0x12345678, 0xF0F0F0F0])
    want = [bin(int(v)).count("1") for v in x]
    assert thm.popcount32(x).tolist() == want
    rng = np.random.RandomState(1)
    r = rng.randint(0, 2 ** 32, 1000, dtype=np.uint64)
    got = thm.popcount32(torch.from_numpy(r.astype(np.int64))).numpy()
    assert np.array_equal(got, np.asarray(jax.lax.population_count(
        jnp.asarray(r.astype(np.uint32)))))
