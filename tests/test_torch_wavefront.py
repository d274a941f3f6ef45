"""Wavefront relaxation (kernel K2) and the planner around it: the port's
plain relaxation is bit-exact with the JAX package's Pallas kernel
(interpret mode) and XLA loop; plan_world/coarse_potential agree exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nclt_slam_tpu.config import DEFAULT as JDEFAULT
from nclt_slam_tpu.ops.wavefront_pallas import wavefront_potential_pallas
from nclt_slam_tpu.planning import wavefront as jwf
from nclt_slam_tpu_torch.config import DEFAULT
from nclt_slam_tpu_torch.ops import wavefront as ops
from nclt_slam_tpu_torch.planning import wavefront as twf

# the test workers share the CPU: one intra-op thread each keeps their
# torch thread pools from oversubscribing it
torch.set_num_threads(1)

BIG = 1e9


def _grid(rng, H, W, lethal_frac=0.15):
    cost = rng.uniform(0.1, 1.0, (H, W)).astype(np.float32)
    cost[rng.rand(H, W) < lethal_frac] = BIG
    phi0 = np.full((H, W), BIG, np.float32)
    phi0[rng.randint(H), rng.randint(W)] = 0.0
    return cost, phi0


def _xla_relax(tc, phi0, n_iter):
    def body(_, p):
        return jnp.minimum(p, jwf._neighbor_min(p, tc, 1.4142135))
    return np.asarray(jax.jit(lambda t, p: jax.lax.fori_loop(
        0, n_iter, body, p))(jnp.asarray(tc), jnp.asarray(phi0)))


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_equals_pallas_and_xla_square(seed):
    rng = np.random.RandomState(seed)
    W, n_iter = 64, 128
    cost, phi0 = _grid(rng, W, W)
    got = ops.wavefront_relax(torch.from_numpy(cost)[None],
                              torch.from_numpy(phi0)[None], n_iter)[0].numpy()
    pallas = np.asarray(wavefront_potential_pallas(
        jnp.asarray(cost), jnp.asarray(phi0), n_iter=n_iter, res=0.1,
        interpret=True))
    assert (got < BIG).mean() > 0.5
    assert np.array_equal(got, pallas)
    assert np.array_equal(got, _xla_relax(cost, phi0, n_iter))


def test_plain_equals_xla_non_square_batch():
    rng = np.random.RandomState(5)
    H, W, n_iter = 30, 58, 96       # the coarse map's aspect, scaled down
    grids = [_grid(rng, H, W) for _ in range(3)]
    tc = torch.from_numpy(np.stack([g[0] for g in grids]))
    p0 = torch.from_numpy(np.stack([g[1] for g in grids]))
    got = ops.wavefront_relax(tc, p0, n_iter).numpy()
    for i, (cost, phi0) in enumerate(grids):
        assert np.array_equal(got[i], _xla_relax(cost, phi0, n_iter))


def test_wrapper_rejects_bad_input():
    x = torch.zeros(1, 8, 8)
    with pytest.raises(ValueError):
        ops.wavefront_relax(x, torch.zeros(1, 8, 9), 4)
    with pytest.raises(TypeError):
        ops.wavefront_relax(x.double(), x.double(), 4)
    y = torch.zeros(1, 8, 8).transpose(1, 2)
    with pytest.raises(ValueError):
        ops.wavefront_relax(y, y, 4)
    with pytest.raises(ValueError):
        ops._launch_shape(8, 2048)
    with pytest.raises(ValueError):
        ops._launch_shape(2000, 400)    # bands exceed shared memory
    for (H, W), (band, ty) in (((192, 192), (24, 5)),
                               ((119, 232), (15, 4))):
        plan = ops._launch_shape(H, W)
        assert (plan.cluster, plan.band_rows, plan.threads_x,
                plan.threads_y) == (8, band, W, ty)
        assert plan.halo == min(ops.HALO_DEPTH, band)


def _cluster_model(tc, phi0, n_iter, plan):
    """The kernel's schedule on the CPU, step for step: per rank a band of
    ``plan.band_rows`` rows and ``plan.halo`` halo rows a side in two
    ping-pong (L, W + 2) buffers with a BIG border; rounds of ``halo``
    local Jacobi steps, each storing every local row but the first and the
    last (a row outside the grid with tc = inf, so that it stays BIG), then
    halo rows refreshed from the two adjacent ranks only; the kernel's
    arithmetic (fminf; the min of the orthogonal, the diagonal, neighbours
    before the add of tc, tc * 1.4142135)."""
    B, H, W = tc.shape
    C, R, h = plan.cluster, plan.band_rows, plan.halo
    L, P = R + 2 * h, W + 2
    mn = torch.fmin
    bufs, tcs = [], []
    for k in range(C):
        g = torch.arange(k * R - h, k * R - h + L)
        inside = (g >= 0) & (g < H)
        buf = torch.full((B, L, P), BIG)
        buf[:, inside, 1:-1] = phi0[:, g[inside]]
        t = torch.full((B, L, W), float("inf"))
        t[:, inside] = tc[:, g[inside]]
        bufs.append([buf, buf.clone()])
        tcs.append(t[:, 1:-1])
    t0 = 0
    while t0 < n_iter:
        s = min(h, n_iter - t0)
        for k in range(C):
            for _ in range(s):
                cur, nxt = bufs[k]
                u, m, d = cur[:, :-2], cur[:, 1:-1], cur[:, 2:]
                orth = mn(mn(u[..., 1:-1], d[..., 1:-1]),
                          mn(m[..., :-2], m[..., 2:]))
                diag = mn(mn(u[..., :-2], u[..., 2:]),
                          mn(d[..., :-2], d[..., 2:]))
                t = tcs[k]
                nxt[:, 1:-1, 1:-1] = mn(m[..., 1:-1],
                                        mn(orth + t, diag + t * ops.DIAG))
                bufs[k] = [nxt, cur]
        t0 += s
        if t0 < n_iter:
            tops = [bufs[k - 1][0][:, R:R + h].clone() if k else None
                    for k in range(C)]
            bottoms = [bufs[k + 1][0][:, h:2 * h].clone() if k < C - 1
                       else None for k in range(C)]
            for k in range(C):
                if k:
                    bufs[k][0][:, :h] = tops[k]
                if k < C - 1:
                    bufs[k][0][:, R + h:] = bottoms[k]
    out = torch.empty_like(phi0)
    for k in range(C):
        n = max(0, min(R, H - k * R))
        out[:, k * R:k * R + n] = bufs[k][0][:, h:h + n, 1:-1]
    return out


SCHEDULE_CASES = [(2, 37, 53, 70), (1, 1, 5, 3), (2, 5, 9, 11),
                  (1, 119, 232, 40), (1, 192, 192, 40)]


@pytest.mark.parametrize("halo", ["1", "kernel"])
@pytest.mark.parametrize("case", SCHEDULE_CASES)
def test_cluster_schedule_equals_plain(case, halo):
    B, H, W, n_iter = case
    plan = ops._launch_shape(H, W, halo=1 if halo == "1" else None)
    rng = np.random.RandomState(H * W + n_iter)
    grids = [_grid(rng, H, W) for _ in range(B)]
    tc = torch.from_numpy(np.stack([g[0] for g in grids]))
    p0 = torch.from_numpy(np.stack([g[1] for g in grids]))
    got = _cluster_model(tc, p0, n_iter, plan)
    ref = ops.wavefront_relax_plain(tc, p0, n_iter)
    assert torch.equal(got, ref)
    if (H, W) == (192, 192) and halo == "kernel":
        pallas = np.asarray(wavefront_potential_pallas(
            jnp.asarray(grids[0][0]), jnp.asarray(grids[0][1]),
            n_iter=n_iter, res=0.1, interpret=True))
        assert np.array_equal(got[0].numpy(), pallas)


def _old_envelope_max_h(W):
    """The tallest grid of width W the first kernel (one block a grid, the
    whole plane in shared memory, at most 64 rows a thread) accepted."""
    H = ops.MAX_SMEM_BYTES // (4 * (W + 2)) - 2
    return min(H, ops.MAX_ROWS_PER_THREAD * max(1, ops.MAX_THREADS // W))


@pytest.mark.parametrize("H, W", [(192, 192), (119, 232), (1, 1), (1, 1024),
                                  (54, 1024), (_old_envelope_max_h(1), 1),
                                  (_old_envelope_max_h(513), 513),
                                  (_old_envelope_max_h(342), 342),
                                  (_old_envelope_max_h(100), 100),
                                  (5, 9), (37, 53)])
def test_cluster_plan(H, W):
    plan = ops._launch_shape(H, W)
    C, R, h = plan.cluster, plan.band_rows, plan.halo
    assert C == ops.CLUSTER == 8 and plan.grid(15) == 15 * C
    # the bands cover every grid row once, in rank order
    bands = [range(k * R, min((k + 1) * R, H)) for k in range(C)]
    assert [r for band in bands for r in band] == list(range(H))
    assert 1 <= h <= R      # halos come from the adjacent ranks only
    assert plan.smem_bytes == ops.smem_bytes(R, h, W) <= ops.MAX_SMEM_BYTES
    # the threads cover the local rows a step may relax, each row of
    # threads some of them, and fit one block
    n_rows = R + 2 * h - 2
    assert plan.threads_x == W and plan.threads_x * plan.threads_y <= 1024
    assert (plan.threads_y - 1) * plan.rows < n_rows <= \
        plan.threads_y * plan.rows <= plan.threads_y * 64
    if (H, W) in ((192, 192), (119, 232)):
        assert h == ops.HALO_DEPTH


def _cfgs(W=64):
    kw = dict(window=W, path_len=96, use_pallas=True)
    return (dataclasses.replace(JDEFAULT.planner, **kw),
            dataclasses.replace(DEFAULT.planner, **kw))


def _cost_windows(rng, B, W):
    cost = rng.uniform(0.0, 40.0, (B, W, W)).astype(np.float32)
    cost[rng.rand(B, W, W) < 0.08] = 99.0
    cost[:, 30:34, 8:56] = 99.0          # a wall the path must go around
    return cost


def test_plan_world_and_coarse_potential_match_jax():
    rng = np.random.RandomState(11)
    B, W = 3, 64
    jpc, tpc = _cfgs(W)
    mc = JDEFAULT.map
    # coarse potential on a small teach map (coarse shape 12 x 19)
    teach = rng.choice(np.array([0, 1, 2], np.int8), (B, 90, 150),
                       p=[0.8, 0.1, 0.1])
    small_map = dataclasses.replace(mc, width_m=15.0, height_m=9.0)
    tmap = dataclasses.replace(DEFAULT.map, width_m=15.0, height_m=9.0)
    goal = np.stack([rng.uniform(-105, -91, B), rng.uniform(-50, -42, B)],
                    -1).astype(np.float32)
    jtc = jax.vmap(lambda g: jwf.coarse_traversal(g, small_map, jpc))(
        jnp.asarray(teach))
    jphi = jax.vmap(lambda t, g: jwf.coarse_potential(t, g, small_map, jpc))(
        jtc, jnp.asarray(goal))
    ttc = twf.coarse_traversal(torch.from_numpy(teach), tmap, tpc)
    tphi = twf.coarse_potential(ttc, torch.from_numpy(goal), tmap, tpc)
    assert np.array_equal(np.asarray(jtc), ttc.numpy())
    assert np.array_equal(np.asarray(jphi), tphi.numpy())

    # window plans: cost crops + border seed from a full-size coarse field
    cost = _cost_windows(rng, B, W)
    r0 = rng.randint(0, 800, B).astype(np.int32)
    c0 = rng.randint(0, 1700, B).astype(np.int32)
    base = np.stack([mc.origin_x + (c0 + 10) * 0.1,
                     mc.origin_y + (r0 + 10) * 0.1], -1).astype(np.float32)
    start = base
    target = base + np.array([4.0, 4.5], np.float32)
    cphi = rng.uniform(0, 60, (B, 119, 232)).astype(np.float32)
    for coarse_goal in (target, target + 5.0):       # fresh, then stale
        jres = jax.vmap(lambda c, a, b, s, t, p, g: jwf.plan_world(
            c, a, b, s, t, mc, jpc, coarse_phi=p, coarse_goal=g))(
            *map(jnp.asarray, (cost, r0, c0, start, target, cphi,
                               coarse_goal)))
        tres = twf.plan_world(*map(torch.from_numpy, (cost, r0, c0, start,
                                                      target)),
                              DEFAULT.map, tpc,
                              coarse_phi=torch.from_numpy(cphi),
                              coarse_goal=torch.from_numpy(coarse_goal))
        assert np.array_equal(np.asarray(jres.ok), tres.ok.numpy())
        assert np.array_equal(np.asarray(jres.n_path), tres.n_path.numpy())
        assert np.array_equal(np.asarray(jres.potential),
                              tres.potential.numpy())
        assert np.array_equal(np.asarray(jres.path_xy), tres.path_xy.numpy())
        assert tres.ok.all() and (tres.n_path > 5).all()


def test_descent_on_open_ground_matches_jax():
    """On a window of free cells the potential is the same in both packages,
    and at many cells a diagonal step and a straight one tie to within one
    float32 rounding; the JAX package's compiled descent fuses
    ``phi + scale * tc`` into one rounding, and the port's must break
    those ties as it does (with two roundings 138 of these 576 starts took
    another path)."""
    W = 24
    jpc, tpc = _cfgs(W)
    mc = JDEFAULT.map
    starts = np.stack(np.meshgrid(np.arange(W), np.arange(W), indexing="ij"),
                      -1).reshape(-1, 2).astype(np.int32)
    B = len(starts)
    cost = np.zeros((B, W, W), np.float32)
    goal = np.tile(np.array([5, 12], np.int32), (B, 1))
    jres = jax.vmap(lambda c, s, g: jwf.plan_window(
        c, (s[0], s[1]), (g[0], g[1]), mc, jpc))(
        jnp.asarray(cost), jnp.asarray(starts), jnp.asarray(goal))
    tres = twf.plan_window(torch.from_numpy(cost),
                           tuple(torch.from_numpy(starts).unbind(1)),
                           tuple(torch.from_numpy(goal).unbind(1)),
                           DEFAULT.map, tpc)
    assert np.array_equal(np.asarray(jres.potential), tres.potential.numpy())
    assert np.array_equal(np.asarray(jres.n_path), tres.n_path.numpy())
    same = (np.asarray(jres.path_xy) == tres.path_xy.numpy()).all((1, 2))
    assert same.all(), f"{(~same).sum()} of {B} paths differ"


def _round32(q):
    """The float32 nearest the rational ``q`` (ties to even)."""
    from fractions import Fraction

    x = np.float32(float(q))
    cands = [np.nextafter(x, np.float32(-np.inf)), x,
             np.nextafter(x, np.float32(np.inf))]
    err = [abs(Fraction(float(v)) - q) for v in cands]
    best = min(err)
    near = [v for v, e in zip(cands, err) if e == best]
    return min(near, key=lambda v: int(np.array(v).view(np.int32)) & 1)


def test_fma32_rounds_once_as_jax_does():
    """``_fma32`` is the correctly rounded ``a * b + c`` (checked against
    exact rational arithmetic) and equals the JAX package's compiled
    ``a * b + c`` on the CPU, the probe's open-ground tie among the
    cases."""
    from fractions import Fraction

    rng = np.random.RandomState(3)
    n = 4000
    a = rng.uniform(0.0, 2.0, n).astype(np.float32)
    b = (rng.uniform(0.0, 1.0, n) * 10.0 ** rng.randint(-3, 2, n)) \
        .astype(np.float32)
    c = (rng.uniform(-1.0, 1.0, n) * 10.0 ** rng.randint(-2, 10, n)) \
        .astype(np.float32)
    a[:3], b[:3], c[:3] = 1.4142135, 0.1, [0.3, 0.34142136, 1e9]
    got = twf._fma32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    want = np.array([_round32(Fraction(float(x)) * Fraction(float(y))
                              + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    assert np.array_equal(got, want)
    assert got[0] == np.float32(0.44142136)        # not 0.4414214
    jit = np.asarray(jax.jit(lambda x, y, z: x * y + z)(a, b, c))
    assert np.array_equal(got, jit)
