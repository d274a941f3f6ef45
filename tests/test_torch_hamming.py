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


# ---------------------------------------------------------------------------
# the kernel's plan and its schedule, rehearsed on the CPU
# ---------------------------------------------------------------------------

INT32_MAX = 2 ** 31 - 1
# the main path's three shapes (P, A, Q, B), as chip_smoke.py's HAMMING_SHAPES
MAIN_SHAPES = [(15, 256, 15, 384), (75, 256, 75, 256), (75, 256, 15, 256)]


def _schedule_model(da, va, db, vb, max_dist, plan):
    """csrc/hamming.cu's schedule on the CPU, block for block: per problem
    and rank r the band of ``plan.band_rows`` a-rows from r * band_rows,
    padded to ``pad_rows`` rows (whole 32-row chunks) and B to ``pad_cols``
    columns (zero words, popc -1024); each distance once, as popc(a) +
    popc(b) - 2 popc(a & b) on the 16 x 8 tiles, masked by min(unsigned,
    BIG); padded keys INT32_MAX; the band's row keys as the min over the
    warps' n-tiles (warp w: n-tiles w, w + NW, ...) and each chunk's, its
    partial column keys as the min over the chunks of each n-tile's column
    minimum over the chunk; every rank's partial column keys merged, rank
    by rank, into every rank's copy; the mutual test from the rank's own
    copy."""
    P, A, _ = da.shape
    Q, B, _ = db.shape
    grp = P // Q
    C, R, Rp, Bp = plan.cluster, plan.band_rows, plan.pad_rows, plan.pad_cols
    nw = plan.threads // 32
    a32, b32 = thm._as_int32(da), thm._as_int32(db)
    big, inval = thm.BIG, -1024
    best_b = torch.empty(P, A, dtype=torch.int64)
    best_d = torch.empty(P, A, dtype=torch.int64)
    matched = torch.empty(P, A, dtype=torch.bool)
    col_idx = torch.arange(Bp)
    for p in range(P):
        q = p // grp
        sb = torch.zeros(Bp, thm.WORDS, dtype=torch.int32)
        sb[:B] = b32[q]
        pb = torch.full((Bp,), inval, dtype=torch.int64)
        pb[:B] = torch.where(vb[q], thm.popcount32(b32[q]).sum(-1), inval)
        colkey = [torch.full((Bp,), INT32_MAX, dtype=torch.int64)
                  for _ in range(C)]
        bands = []
        for r in range(C):
            a0 = r * R
            nr = max(0, min(R, A - a0))
            if nr == 0:
                bands.append(None)
                continue
            sa = torch.zeros(Rp, thm.WORDS, dtype=torch.int32)
            sa[:nr] = a32[p, a0:a0 + nr]
            pa = torch.full((Rp,), inval, dtype=torch.int64)
            pa[:nr] = torch.where(va[p, a0:a0 + nr],
                                  thm.popcount32(sa[:nr]).sum(-1), inval)
            both = thm.popcount32(sa[:, None, :] & sb[None, :, :]).sum(-1)
            s = pa[:, None] + pb[None, :] - 2 * both.to(torch.int64)
            dm = torch.where(s < 0, big, s.clamp(max=big))   # unsigned min
            rk = dm * B + col_idx
            rk[:, B:] = INT32_MAX
            ck = dm * A + (a0 + torch.arange(Rp))[:, None]
            ck[nr:] = INT32_MAX
            assert rk.max() <= INT32_MAX and ck.max() <= INT32_MAX
            tiles = rk.reshape(Rp, Bp // 8, 8)
            rowkey = torch.stack([tiles[:, w::nw].amin((1, 2))
                                  if tiles[:, w::nw].numel() else
                                  torch.full((Rp,), INT32_MAX)
                                  for w in range(nw)]).amin(0)
            cpart = ck.reshape(Rp // 32, 32, Bp).amin(1).amin(0)
            for k in range(C):
                colkey[k][:B] = torch.minimum(colkey[k][:B], cpart[:B])
            bands.append((r, a0, nr, rowkey[:nr]))
        for band in bands:
            if band is None:
                continue
            r, a0, nr, rowkey = band
            bb, d = rowkey % B, rowkey // B
            ck = colkey[r][bb]
            a = a0 + torch.arange(nr)
            best_b[p, a], best_d[p, a] = bb, d
            matched[p, a] = (ck == d * A + a) & (d <= max_dist) & (d < big)
    return best_b.to(torch.int32), matched, best_d.to(torch.int32)


def _schedule_case(name):
    """(desc_a, valid_a, desc_b, valid_b) of a rehearsal case, numpy."""
    rng = np.random.RandomState(sum(map(ord, name)))
    if name == "7x5":
        probs = [_problem(rng, 7, 5)]
        grp = 1
    elif name == "1000x300_group2":
        probs = [_problem(rng, 1000, 300) for _ in range(4)]
        grp = 2
    elif name == "all_invalid":
        probs = [_problem(rng, 40, 70) for _ in range(3)]
        probs[1] = (probs[1][0], np.zeros(40, bool)) + probs[1][2:]
        grp = 1
    elif name == "identical_rows":
        # every a-row and b-row the same word pattern: every distance ties
        row = rng.randint(0, 2 ** 32, 8, dtype=np.uint64).astype(np.uint32)
        probs = [(np.tile(row, (33, 1)), np.ones(33, bool),
                  np.tile(row, (65, 1)), np.ones(65, bool))]
        grp = 1
    else:
        P, A, Q, B = MAIN_SHAPES[int(name[-1])]
        grp = P // Q
        probs = [_problem(rng, A, B) for _ in range(P)]
        probs[P // 2] = (probs[P // 2][0], np.zeros(A, bool)) + \
            probs[P // 2][2:]
    da, va, db, vb = (np.stack(x) for x in zip(*probs))
    return da, va, db[::grp], vb[::grp]


SCHEDULE_CASES = ["7x5", "1000x300_group2", "all_invalid", "identical_rows",
                  "main_0", "main_1", "main_2"]


@pytest.mark.parametrize("case", SCHEDULE_CASES)
def test_kernel_schedule_equals_plain_and_pallas(case):
    da, va, db, vb = _schedule_case(case)
    P, A = va.shape
    Q, B = vb.shape
    plan = thm.plan(P, A, B)
    args = [_t(x) for x in (da, va, db, vb)]
    got = _schedule_model(*args, 64, plan)
    ref = thm.cross_check_plain(*args, 64)
    for g, r, name in zip(got, ref, ("best_b", "matched", "best_d")):
        assert torch.equal(g, r), name
    if case == "all_invalid":
        assert not got[1][1].any() and (got[0][1] == 0).all()
        assert (got[2][1] == thm.BIG).all()
    if case == "identical_rows":
        assert (got[2] == 0).all() and (got[0] == 0).all()
        assert got[1][0, 0] and not got[1][0, 1:].any()
    grp = P // Q
    for p in sorted({0, P // 2, P - 1}):
        pal = cross_check_pallas(
            jnp.asarray(da[p]), jnp.asarray(va[p]), jnp.asarray(db[p // grp]),
            jnp.asarray(vb[p // grp]), max_dist=64, interpret=True)
        for g, x in zip(got, pal):
            assert np.array_equal(g[p].numpy(), np.asarray(x).astype(
                g.numpy().dtype))


def test_popcount_identity_with_top_bit():
    """popc(a) + popc(b) - 2 popc(a & b) == popc(a ^ b) on int32-held words,
    the sign bit set in either or both."""
    words = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0xC0000001,
                      0xDEADBEEF, 0x12345678], np.uint64)
    rng = np.random.RandomState(5)
    words = np.concatenate([words, rng.randint(2 ** 31, 2 ** 32, 200,
                                               dtype=np.uint64)])
    a = thm._as_int32(torch.from_numpy(words.astype(np.int64)))
    x, y = a[:, None], a[None, :]
    pc = thm.popcount32
    assert torch.equal(pc(x) + pc(y) - 2 * pc(x & y), pc(x ^ y))
    assert (pc(a) == torch.tensor([bin(int(w)).count("1")
                                   for w in words])).all()


# the main path's shapes, the card tests' shapes and the corners of the
# first kernel's envelope: (A + B) * 37 bytes <= 232448 and the int32 keys
# (BIG * n + n <= INT32_MAX: n <= 2146)
PLAN_SHAPES = [(15, 256, 384), (75, 256, 256), (3, 7, 5), (4, 1000, 300),
               (2, 33, 65), (1, 1, 1), (1, 2146, 2146), (1, 1, 2146),
               (1, 2146, 1), (200, 2146, 2146), (1, 17, 9), (9, 8, 8)]


@pytest.mark.parametrize("P, A, B", PLAN_SHAPES)
def test_kernel_plan(P, A, B):
    p = thm.plan(P, A, B)
    C, R = p.cluster, p.band_rows
    assert C in thm.CLUSTER_SIZES and p.grid(P) == P * C
    # the bands cover every a-row once, in rank order, the last one too
    bands = [range(k * R, min((k + 1) * R, A)) for k in range(C)]
    assert [a for band in bands for a in band] == list(range(A))
    assert len(bands[-1]) > 0
    assert p.pad_rows % 32 == 0 and R <= p.pad_rows < R + 32
    assert p.pad_cols % 8 == 0 and B <= p.pad_cols < B + 8
    # a warp for each 8 columns, at most 8 warps (__launch_bounds__(256))
    assert p.threads == 32 * min(8, p.pad_cols // 8)
    assert p.smem_bytes == thm.smem_bytes(p.pad_rows,
                                          p.pad_cols) <= thm.MAX_SMEM_BYTES
    # every real key fits an int32
    n = max(A, B)
    assert thm.BIG * n + n - 1 <= INT32_MAX
    if (P, A, B) == (15, 256, 384):       # the VIO call: 120 blocks
        assert (C, R, p.pad_rows, p.pad_cols) == (8, 32, 32, 384)
    if (P, A, B) == (75, 256, 256):       # the matcher call: 600 blocks
        assert (C, R, p.pad_rows, p.pad_cols) == (8, 32, 32, 256)


def test_kernel_plan_cluster_override():
    assert thm.plan(75, 256, 256, cluster=2).cluster == 2
    assert thm.plan(1, 3, 9, cluster=8).cluster == 2     # no empty band
    with pytest.raises(ValueError):
        thm.plan(1, 8, 8, cluster=3)
