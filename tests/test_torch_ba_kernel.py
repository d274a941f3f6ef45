"""The schedule of the bundle-adjustment kernel K3 (``csrc/ba.cu``),
rehearsed on the CPU in float32 torch, and its plan (``ops/ba.py:plan``).

``_schedule_model`` runs the kernel's order of work on each window: the C
landmark slices of the plan, each rank's partial reduced system from its
own landmarks (a chunk at a time: the 30 numbers of each observation, the
landmark blocks and their inverses, the A^-1-weighted blocks, only the
blocks ka <= kb of the Schur product, with H_kk and the gradient on the
diagonal blocks), the rank-ordered sum of each band of rows with the band's
pose-only terms, the upper blocks mirrored, the blocked unpivoted Cholesky
S = U^T U over 32-column panels with its zero-step rule, and the pose
update every rank makes.  It is held by tolerance, not bit for bit: the
card contracts multiply-adds into FMAs where torch on the CPU does not, and
torch's reductions sum in their own order.  The tolerances are the smoke's
(``chip_smoke.py``: poses 2e-4 m, quaternions 2e-5, points 1e-3 m, cost
1e-3 relative) against ``solve_ba_plain`` in float64 on ``chip_smoke``'s
``BA_SHAPES``, and the JAX tests' against JAX's ``vmap(solve_ba)``.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from test_torch_ba import CASES, _assert_close, _windows  # noqa: E402

import chip_smoke  # noqa: E402
from nclt_slam_tpu.config import DEFAULT as JCFG  # noqa: E402
from nclt_slam_tpu.vio import ba as jba  # noqa: E402
from nclt_slam_tpu_torch.config import DEFAULT as TCFG  # noqa: E402
from nclt_slam_tpu_torch.core.quat import quat_mul, so3_exp  # noqa: E402
from nclt_slam_tpu_torch.ops import ba as ops_ba  # noqa: E402
from nclt_slam_tpu_torch.vio import ba as tba  # noqa: E402

CAM, VCFG = TCFG.camera, TCFG.vio
PANEL = ops_ba.PANEL


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small CPU tensors: one torch thread is faster than eight."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _observations(pos, quat, pts, uv, z, w_obs):
    """The 30 numbers of each observation (B, K, L, ...): Bs = M[:, 3:6]
    (6 x 3), M[0:3, 0:3] (3 x 3) and v, with M = Jp^T w Jp and v = Jp^T w
    r; and the cost w |r|^2."""
    r, Jp, _ = tba.reprojection(pos, quat, pts, uv, z, CAM)
    w = tba.robust_weights(r, w_obs, VCFG)
    wJp = Jp * w[..., None, None]
    M = torch.einsum("bkpri,bkprj->bkpij", wJp, Jp)
    v = torch.einsum("bkpri,bkpr->bkpi", wJp, r)
    return M[..., :, 3:], M[..., :3, :3], v, w * (r * r).sum(-1)


def _blocked_cholesky_solve(S, rhs, N):
    """The kernel's reduced solve of each (npad x npad) system: S = U^T U
    right-looking over 32-column panels (a diagonal tile column by column,
    the panel's columns by substitution, the trailing upper triangle), the
    forward substitution panel by panel, then U x = y panel by panel from
    the last.  A pivot that is not positive (or NaN) is taken as 1 and
    zeroes the window's whole step; a non-finite entry of x becomes 0."""
    B, npad, _ = S.shape
    A = torch.triu(S).clone()
    y = rhs.clone()
    bad = torch.zeros(B, dtype=torch.bool)
    for t0 in range(0, npad, PANEL):
        t1 = t0 + PANEL
        for c in range(t0, t1):
            d = A[:, c, c]
            fail = ~(d > 0)
            bad |= fail
            d = torch.where(fail, torch.ones_like(d), d)
            u = torch.sqrt(d)
            A[:, c, c] = u
            A[:, c, c + 1:t1] = A[:, c, c + 1:t1] / u[:, None]
            A[:, c + 1:t1, c + 1:t1] -= torch.triu(
                A[:, c, c + 1:t1, None] * A[:, c, None, c + 1:t1])
            y[:, c] = y[:, c] / u
            y[:, c + 1:t1] -= A[:, c, c + 1:t1] * y[:, c:c + 1]
        if t1 < npad:
            U = A[:, t0:t1, t0:t1]
            X = A[:, t0:t1, t1:].clone()
            for c in range(PANEL):        # U^T X' = X, column block by row
                X[:, c] = X[:, c] / U[:, c, c:c + 1]
                X[:, c + 1:] -= U[:, c, c + 1:, None] * X[:, c:c + 1]
            A[:, t0:t1, t1:] = X
            y[:, t1:] -= torch.einsum("bc,bcr->br", y[:, t0:t1], X)
            A[:, t1:, t1:] -= torch.triu(X.transpose(1, 2) @ X)
    x = y
    for t0 in range(npad - PANEL, -1, -PANEL):
        t1 = t0 + PANEL
        if t1 < npad:
            x[:, t0:t1] -= torch.einsum("bcr,br->bc", A[:, t0:t1, t1:],
                                        x[:, t1:])
        for c in range(t1 - 1, t0 - 1, -1):
            x[:, c] = x[:, c] / A[:, c, c]
            x[:, t0:c] -= A[:, t0:c, c] * x[:, c:c + 1]
    x = torch.where(bad[:, None], torch.zeros_like(x), x)
    x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    return x[:, :N]


def _schedule_model(prob, iters, plan):
    """csrc/ba.cu's schedule on B windows (see the module's docstring)."""
    B, K, _ = prob.kf_pos.shape
    P = prob.points.shape[1]
    N, npad = 6 * K, ops_ba.padded(K)
    damping = VCFG.lm_damping
    w_rel = tba.broadcast_w_rel(prob.w_rel, B, K - 1, "cpu")
    prior = prob.pt_prior_w if prob.pt_prior_w is not None else \
        torch.zeros(B, P)
    eye3 = torch.eye(3)
    upper = torch.ones(K, K).triu().bool()               # blocks ka <= kb
    pos, quat, pts = prob.kf_pos, prob.kf_quat, prob.points.clone()
    slices = plan.slices(P)
    cost = None
    for _ in range(iters):
        partial, partial_rhs, partial_cost, kept = [], [], [], []
        for p0, p1 in slices:
            S_r = torch.zeros(B, K, K, 6, 6)
            rhs_r = torch.zeros(B, K, 6)
            cost_r = torch.zeros(B)
            chunks = []
            for l0 in range(p0, p1, plan.chunk):
                l1 = min(p1, l0 + plan.chunk)
                Bs, Mrr, v, c2 = _observations(
                    pos, quat, pts[:, l0:l1], prob.obs_uv[:, :, l0:l1],
                    prob.obs_z[:, :, l0:l1], prob.obs_w[:, :, l0:l1])
                cost_r = cost_r + c2.sum((1, 2))
                A = Bs[..., 3:, :].sum(1)                    # (B, L, 3, 3)
                pw = prior[:, l0:l1]
                Ainv = tba._inv3x3(A + (pw[..., None, None] + damping) * eye3)
                gl = -v[..., 3:].sum(1) + pw[..., None] * (
                    pts[:, l0:l1] - prob.points[:, l0:l1])
                Cs = Bs @ Ainv[:, None]                      # (B, K, L, 6, 3)
                schur = -torch.einsum("nkpim,nlpjm->nklij", Cs, Bs)
                M = torch.cat([torch.cat([Mrr, Bs[..., :3, :]], -1),
                               torch.cat([Bs[..., :3, :].transpose(-1, -2),
                                          Bs[..., 3:, :]], -1)], -2)
                kk = torch.arange(K)
                schur[:, kk, kk] += M.sum(2)
                S_r = S_r + schur * upper[:, :, None, None]
                rhs_r = rhs_r - v.sum(2) - torch.einsum("bapim,bpm->bai",
                                                        Cs, gl)
                chunks.append((l0, l1, Ainv, gl))
            partial.append(S_r)
            partial_rhs.append(rhs_r)
            partial_cost.append(cost_r)
            kept.append(chunks)
        # the relative factors, the owned ones' cost on each rank's partial
        args = (pos[:, :-1], quat[:, :-1], pos[:, 1:], quat[:, 1:])
        r_rel = tba.rel_residual(*args, prob.rel_dp, prob.rel_dq)
        Ji, Jj = tba.rel_jacobians(*args, prob.rel_dq)
        rel_cost = w_rel * (r_rel * r_rel).sum(-1)           # (B, K-1)
        for r, (k0, k1) in enumerate(plan.bands(K)):
            for f in range(k0 // 6, min(k1 // 6, K - 1)):
                partial_cost[r] = partial_cost[r] + rel_cost[:, f]
        cost = partial_cost[0]
        for c_r in partial_cost[1:]:
            cost = cost + c_r
        # each band: the partial systems summed in rank order, then the
        # band's pose-only terms
        S = partial[0].clone()
        rhs = partial_rhs[0].clone()
        for S_r, rhs_r in zip(partial[1:], partial_rhs[1:]):
            S = S + S_r
            rhs = rhs + rhs_r
        wJi = w_rel[..., None, None] * Ji
        wJj = w_rel[..., None, None] * Jj
        ii = torch.arange(K - 1)
        S[:, ii, ii] += torch.einsum("bkri,bkrj->bkij", wJi, Ji)
        S[:, ii + 1, ii + 1] += torch.einsum("bkri,bkrj->bkij", wJj, Jj)
        S[:, ii, ii + 1] += torch.einsum("bkri,bkrj->bkij", wJi, Jj)
        kk = torch.arange(K)
        S[:, kk, kk] += damping * torch.eye(6)
        S[:, 0, 0] += 1e4 * torch.eye(6)
        rhs[:, :-1] -= torch.einsum("bkri,bkr->bki", wJi, r_rel)
        rhs[:, 1:] -= torch.einsum("bkri,bkr->bki", wJj, r_rel)
        # the upper blocks mirrored into a padded system
        S = S * upper[:, :, None, None]
        S = S + (S * ~torch.eye(K, dtype=torch.bool)[:, :, None, None]) \
            .transpose(1, 2).transpose(-1, -2)
        Sp = torch.eye(npad).repeat(B, 1, 1)
        Sp[:, :N, :N] = S.permute(0, 1, 3, 2, 4).reshape(B, N, N)
        rp = torch.zeros(B, npad)
        rp[:, :N] = rhs.reshape(B, N)
        dx = _blocked_cholesky_solve(Sp, rp, N)
        # each rank's landmarks at the old linearization point
        for chunks in kept:
            for l0, l1, Ainv, gl in chunks:
                Bs, _, _, _ = _observations(
                    pos, quat, pts[:, l0:l1], prob.obs_uv[:, :, l0:l1],
                    prob.obs_z[:, :, l0:l1], prob.obs_w[:, :, l0:l1])
                q = torch.einsum("bkpim,bki->bpm", Bs, dx.reshape(B, K, 6))
                pts[:, l0:l1] -= (Ainv @ (gl - q)[..., None])[..., 0]
        d = dx.reshape(B, K, 6)
        pos = pos + d[..., 3:]
        quat = quat_mul(quat, so3_exp(d[..., :3]))
        quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    return tba.BAResult(pos, quat, pts, cost)


def _within(out, ref, shape):
    err = {f: (getattr(out, f).double() - getattr(ref, f)).abs().max().item()
           for f in ("kf_pos", "kf_quat", "points")}
    cost = ((out.final_cost.double() - ref.final_cost).abs()
            / ref.final_cost.abs()).max().item()
    print(f"rehearsal {shape}: {err}, cost {cost:.2e} relative")
    assert err["kf_pos"] <= chip_smoke.BA_POS_ATOL_M, err
    assert err["kf_quat"] <= chip_smoke.BA_QUAT_ATOL, err
    assert err["points"] <= chip_smoke.BA_PTS_ATOL_M, err
    assert cost <= chip_smoke.BA_COST_RTOL, cost


def _f64(prob):
    return tba.BAProblem(*(t.double() if torch.is_tensor(t) else t
                           for t in prob))


@pytest.mark.parametrize("shape", chip_smoke.BA_SHAPES,
                         ids=lambda s: "x".join(map(str, s[:4])))
def test_schedule_matches_plain_in_float64(shape):
    B, K, P, iters, prior, w_rel = shape
    prob, _ = chip_smoke.consistent_windows(range(B), "cpu", K=K, P=P,
                                            w_rel=w_rel, prior=prior)
    got = _schedule_model(prob, iters, ops_ba.plan(B, K, P))
    ref = tba.solve_ba_plain(_f64(prob), CAM, VCFG, iters=iters)
    _within(got, ref, shape)


@pytest.mark.parametrize("cluster", [1, 2, 4])
def test_schedule_at_every_cluster_size(cluster):
    """Other slices, bands and chunks give the same solve (C = 8 is the
    plan's own at the rollout's shape, above)."""
    shape = chip_smoke.BA_ROLLOUT
    B, K, P, iters, prior, w_rel = shape
    B = 3
    prob, _ = chip_smoke.consistent_windows(range(B), "cpu", K=K, P=P,
                                            w_rel=w_rel, prior=prior)
    got = _schedule_model(prob, iters, ops_ba.plan(B, K, P, cluster=cluster))
    ref = tba.solve_ba_plain(_f64(prob), CAM, VCFG, iters=iters)
    _within(got, ref, (B, K, P, iters, cluster))


@pytest.mark.parametrize("name", ["batch", "point_prior"])
def test_schedule_matches_jax(name):
    """Free points over ten iterations, and a point prior over six: each
    JAX compile takes seconds, so two of the JAX tests' four cases."""
    seeds, K, P, iters, prior, *tols = CASES[name]
    tprob, jprob, _ = _windows(seeds, K, P, prior)
    got = _schedule_model(tprob, iters, ops_ba.plan(len(list(seeds)), K, P))
    ref = jax.vmap(lambda p: jba.solve_ba(p, JCFG.camera, JCFG.vio,
                                          iters=iters))(jprob)
    _assert_close(got, ref, tols)


def test_blocked_cholesky_solves_spd_and_refuses_the_rest():
    rng = np.random.RandomState(0)
    Ms = rng.normal(size=(3, 70, 70))
    H = Ms @ Ms.transpose(0, 2, 1) + 70 * np.eye(70)
    H[1, 5, 5] = -1.0                     # not positive definite
    b = rng.normal(size=(3, 70))
    S = torch.eye(96).repeat(3, 1, 1)
    S[:, :70, :70] = torch.from_numpy(H).float()
    rhs = torch.zeros(3, 96)
    rhs[:, :70] = torch.from_numpy(b).float()
    x = _blocked_cholesky_solve(S, rhs, 70).double().numpy()
    for i in (0, 2):
        np.testing.assert_allclose(x[i], np.linalg.solve(H[i], b[i]),
                                   atol=1e-5)
    assert (x[1] == 0).all()


PLAN_SHAPES = [s[:3] for s in chip_smoke.BA_SHAPES] + \
    [s[:3] for s in chip_smoke.BA_SWEEP] + [chip_smoke.BA_BENCH[:3]]


@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_plan_covers_and_fits(shape):
    B, K, P = shape
    for cluster in (None, 1, 2, 4, 8):
        try:
            p = ops_ba.plan(B, K, P, cluster=cluster)
        except ValueError:
            assert cluster == 1 and K > 16, (shape, cluster)
            continue
        assert p.smem_bytes <= ops_ba.MAX_SMEM_BYTES
        assert p.smem_bytes == ops_ba.smem_bytes(K, p.landmarks_per_rank,
                                                 p.chunk, p.kept)
        assert p.kept in (p.landmarks_per_rank, p.chunk)
        assert 1 <= p.chunk <= min(ops_ba.MAX_CHUNK, p.landmarks_per_rank)
        assert p.threads == ops_ba.THREADS
        # every landmark in exactly one rank, every row in exactly one band
        owners = np.zeros(P, int)
        for a, b in p.slices(P):
            owners[a:b] += 1
        assert (owners == 1).all()
        rows = np.zeros(6 * K, int)
        for a, b in p.bands(K):
            rows[a:b] += 1
        assert (rows == 1).all()
        assert p.slices(P)[-1][1] > p.slices(P)[-1][0]   # last slice used


def test_plan_rule_and_refusal():
    assert ops_ba.plan(*chip_smoke.BA_ROLLOUT[:3]).cluster == 8
    assert ops_ba.plan(*chip_smoke.BA_BENCH[:3]).grid(
        chip_smoke.BA_BENCH[0]) <= ops_ba.SMS
    # a 40-keyframe window: its reduced system alone is beyond a block's
    # shared memory
    for cluster in (None, 1, 8):
        with pytest.raises(ValueError):
            ops_ba.plan(1, 40, 64, cluster=cluster)
    with pytest.raises(ValueError):
        ops_ba.plan(1, 6, 64, cluster=3)


def test_non_pd_window_takes_a_zero_pose_step_alone():
    """A window whose reduced system is not positive definite (a negative
    relative-factor weight) keeps its poses; its neighbours equal their
    solves alone; the plain version does the same."""
    prob, _ = chip_smoke.consistent_windows(range(3), "cpu", K=6, P=40)
    w = torch.full((3, 5), 100.0)
    w[1] = -1e6
    bad = prob._replace(w_rel=w)
    p = ops_ba.plan(3, 6, 40)
    got = _schedule_model(bad, 3, p)
    plain = tba.solve_ba_plain(bad, CAM, VCFG, iters=3)
    for res in (got, plain):
        assert torch.equal(res.kf_pos[1], prob.kf_pos[1])
        assert torch.allclose(res.kf_quat[1], prob.kf_quat[1], atol=1e-7)
    alone = _schedule_model(prob._replace(w_rel=w[[0, 2]], **{
        f: getattr(prob, f)[[0, 2]] for f in (
            "kf_pos", "kf_quat", "points", "obs_uv", "obs_z", "obs_w",
            "rel_dp", "rel_dq")}), 3, ops_ba.plan(2, 6, 40))
    for a, b in zip(got, alone):
        torch.testing.assert_close(a[[0, 2]], b, rtol=0, atol=1e-6)
