"""Sliding-window bundle adjustment: the port's ``solve_ba`` (its plain
PyTorch version on the CPU) against the JAX package's XLA solver
(``vio/ba.py:solve_ba`` under ``vmap``) and its Pallas kernel in interpret
mode (``ops/ba_pallas.py:solve_ba_pallas``), on the same numpy windows made
from a seed.

Tolerances are those of the JAX package's ``tests/test_ba_pallas.py`` for
its two solvers: on consistent windows all of them converge to one optimum
to float32 precision (poses 2e-4 m, quaternions 2e-5, points 1e-3 m, cost
1e-3 relative; 5e-4 m / 2e-3 m for the shorter six-iteration cases).  The
solvers differ in the reduced solve (Cholesky, Gauss-Jordan) and in
summation order.  The analytic Jacobians are held against
``torch.func.jacfwd`` of the residuals to 1e-3 relative (float32 forward
differences of the same arithmetic).
"""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from test_ba import make_problem as j_make_problem  # noqa: E402

from nclt_slam_tpu.config import DEFAULT as JCFG  # noqa: E402
from nclt_slam_tpu.ops.ba_pallas import solve_ba_pallas  # noqa: E402
from nclt_slam_tpu.vio import ba as jba  # noqa: E402
from nclt_slam_tpu_torch import interop  # noqa: E402
from nclt_slam_tpu_torch.config import DEFAULT as TCFG  # noqa: E402
from nclt_slam_tpu_torch.core.quat import quat_mul, quat_to_mat, so3_exp  # noqa: E402
from nclt_slam_tpu_torch.vio import ba as tba  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent.parent))
import chip_smoke as ba_problems  # noqa: E402  (the port's BA generators)

torch.set_num_threads(1)

# (seeds, K, P, iters, point prior, pos atol, quat atol, points atol):
# the four cases of tests/test_ba_pallas.py
CASES = {
    "batch": (range(3), 6, 64, 10, None, 2e-4, 2e-5, 1e-3),
    "truth": ([4], 6, 64, 10, None, 2e-4, 2e-5, 1e-3),
    "point_prior": ([5], 6, 40, 6, 50.0, 5e-4, 2e-5, 2e-3),
    "window_sizes": (range(2), 10, 48, 6, None, 5e-4, 2e-5, 2e-3),
}


def _windows(seeds, K, P, prior):
    """The same numpy windows as a port problem and a JAX problem."""
    tprob, truth = ba_problems.consistent_windows(seeds, "cpu", K=K, P=P,
                                                  prior=prior)
    leaves = interop.to_numpy_tree(tprob)
    jprob = jba.BAProblem(**{
        f: None if v is None else jnp.asarray(
            np.full(len(list(seeds)), v, np.float32) if f == "w_rel" else v)
        for f, v in leaves._asdict().items()})
    return tprob, jprob, truth


@pytest.fixture(scope="module", params=list(CASES))
def solved(request):
    seeds, K, P, iters, prior, *tols = CASES[request.param]
    tprob, jprob, truth = _windows(seeds, K, P, prior)
    out = tba.solve_ba(tprob, TCFG.camera, TCFG.vio, iters=iters)
    return request.param, jprob, out, truth, iters, tols


def _assert_close(out, ref, tols):
    pos_tol, quat_tol, pts_tol = tols
    np.testing.assert_allclose(out.kf_pos.numpy(), ref.kf_pos, atol=pos_tol)
    np.testing.assert_allclose(out.kf_quat.numpy(), ref.kf_quat, atol=quat_tol)
    np.testing.assert_allclose(out.points.numpy(), ref.points, atol=pts_tol)
    np.testing.assert_allclose(out.final_cost.numpy(), ref.final_cost,
                               rtol=1e-3)


def test_plain_matches_jax_xla_solver(solved):
    _, jprob, out, _, iters, tols = solved
    ref = jax.vmap(lambda p: jba.solve_ba(p, JCFG.camera, JCFG.vio,
                                          iters=iters))(jprob)
    _assert_close(out, ref, tols)


def test_plain_matches_jax_pallas_kernel(solved):
    _, jprob, out, _, iters, tols = solved
    ref = solve_ba_pallas(jprob, JCFG.camera, JCFG.vio, iters=iters,
                          interpret=True)
    _assert_close(out, ref, tols)


@pytest.mark.parametrize("name", ["batch", "truth"])
def test_plain_converges_to_truth(name):
    """Free points and a ten-iteration solve reach the generator's truth."""
    seeds, K, P, iters, prior, *_ = CASES[name]
    tprob, _, (gt_pos, gt_pts) = _windows(seeds, K, P, prior)
    out = tba.solve_ba(tprob, TCFG.camera, TCFG.vio, iters=iters)
    pe = np.linalg.norm(out.kf_pos.numpy() - gt_pos, axis=-1)
    assert pe.max() < 0.05, pe
    assert np.linalg.norm(out.points.numpy() - gt_pts, axis=-1).mean() < 0.1
    assert np.isfinite(out.final_cost.numpy()).all()


@pytest.mark.parametrize("kw", [dict(seed=0), dict(seed=5, P=40),
                                dict(seed=1, K=10, P=48)])
def test_make_problem_equals_the_jax_tests_generator(kw):
    fields, gt_pos, gt_quat, pts = ba_problems.make_problem(**kw)
    jprob, j_gt_pos, j_gt_quat, j_pts, _, _ = j_make_problem(**kw)
    np.testing.assert_array_equal(gt_pos, j_gt_pos)
    np.testing.assert_array_equal(pts, j_pts)
    np.testing.assert_allclose(gt_quat, j_gt_quat, atol=1e-7)
    for f, v in fields.items():
        np.testing.assert_allclose(v, np.asarray(getattr(jprob, f)),
                                   atol=1e-4, err_msg=f)
    # the same observations are visible: the draws stayed in step
    np.testing.assert_array_equal(fields["obs_w"], np.asarray(jprob.obs_w))


def _pose_inputs(seed, n):
    rng = np.random.RandomState(seed)
    f = lambda *s: torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))  # noqa: E731
    q = lambda: torch.nn.functional.normalize(f(n, 4), dim=-1)  # noqa: E731
    return f, q


def test_relative_factor_jacobians_match_jacfwd():
    n = 6
    f, q = _pose_inputs(0, n)
    pi, pj, dp = f(n, 3), f(n, 3), f(n, 3)
    qi, qj, dq = q(), q(), q()
    # one factor at its measurement (the rollout's: zero rotation residual)
    dq[0] = quat_mul(torch.cat([-qi[0, :3], qi[0, 3:]]), qj[0])
    # and one a small rotation away from it
    dq[1] = quat_mul(quat_mul(torch.cat([-qi[1, :3], qi[1, 3:]]), qj[1]),
                     so3_exp(torch.tensor([1e-3, -2e-3, 5e-4])))
    Ji, Jj = tba.rel_jacobians(pi, qi, pj, qj, dq)
    zero6 = torch.zeros(6)
    for k in range(n):
        def res_i(d):
            return tba.rel_residual(pi[k] + d[3:],
                                    quat_mul(qi[k], so3_exp(d[:3])),
                                    pj[k], qj[k], dp[k], dq[k])

        def res_j(d):
            return tba.rel_residual(pi[k], qi[k], pj[k] + d[3:],
                                    quat_mul(qj[k], so3_exp(d[:3])),
                                    dp[k], dq[k])

        for J, fn in ((Ji, res_i), (Jj, res_j)):
            # (under jacfwd the scalar branches of torch.where promote the
            # tangent to float64)
            want = torch.func.jacfwd(fn)(zero6).to(torch.float32)
            torch.testing.assert_close(J[k], want, rtol=1e-3, atol=1e-5)


def test_relative_factor_residual_matches_jax():
    n = 5
    f, q = _pose_inputs(1, n)
    args = (f(n, 3), q(), f(n, 3), q(), f(n, 3), q())

    def j_rel(pi, qi, pj, qj, dp, dq):   # vio/ba.py:rel_residual
        from nclt_slam_tpu.core.quat import quat_conj, so3_log
        from nclt_slam_tpu.core.quat import quat_mul as jqm
        from nclt_slam_tpu.core.quat import quat_to_mat as jq2m
        dq_est = jqm(quat_conj(qi), qj)
        dp_est = jq2m(qi).T @ (pj - pi)
        return jnp.concatenate([so3_log(jqm(quat_conj(dq), dq_est)),
                                dp_est - dp])

    want = jax.vmap(j_rel)(*(jnp.asarray(a.numpy()) for a in args))
    np.testing.assert_allclose(tba.rel_residual(*args).numpy(), want,
                               atol=2e-6)


def test_reprojection_jacobians_match_jacfwd():
    """One observation at a time: jacfwd of the residual as the JAX package
    writes it (``_residual_one``: increments applied, then projected)."""
    cam = TCFG.camera
    rng = np.random.RandomState(2)
    K, P = 3, 7
    pos = torch.from_numpy(rng.normal(0, 0.3, (K, 3)).astype(np.float32))
    quat = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(0, 0.2, (K, 4)).astype(np.float32))
        + torch.tensor([0.0, 0.0, 0.0, 1.0]), dim=-1)
    pts = torch.from_numpy(np.stack([rng.uniform(3, 12, P),
                                     rng.uniform(-4, 4, P),
                                     rng.uniform(0, 2, P)], -1)
                           .astype(np.float32))
    pts[0] = pos[0] + torch.tensor([-1.0, 0.2, 0.1])   # behind: z clamped
    obs_uv = torch.from_numpy(rng.uniform(0, 640, (K, P, 2)).astype(np.float32))
    obs_z = torch.from_numpy(rng.uniform(1, 12, (K, P)).astype(np.float32))
    r, Jp, Jl = tba.reprojection(pos, quat, pts, obs_uv, obs_z, cam)

    def residual_one(dpose, dX, k, p):
        q_new = quat_mul(quat[k], so3_exp(dpose[:3]))
        y = ((pts[p] + dX - pos[k] - dpose[3:])[:, None]
             * quat_to_mat(q_new)).sum(0)
        pc = torch.stack([-y[1], -(y[2] - cam.cam_offset_up),
                          y[0] - cam.cam_offset_fwd])
        z = pc[2].clamp_min(0.1)
        sig = (cam.depth_noise_rel_per_m * obs_z[k, p] ** 2).clamp_min(0.02)
        return torch.stack([cam.fx * pc[0] / z + cam.cx - obs_uv[k, p, 0],
                            cam.fy * pc[1] / z + cam.cy - obs_uv[k, p, 1],
                            2.0 * (pc[2] - obs_z[k, p]) / sig])

    zero6, zero3 = torch.zeros(6), torch.zeros(3)
    for k in range(K):
        for p in range(P):
            torch.testing.assert_close(r[k, p], residual_one(zero6, zero3, k, p),
                                       rtol=1e-5, atol=1e-3)
            want_p = torch.func.jacfwd(
                lambda d: residual_one(d, zero3, k, p))(zero6).to(torch.float32)
            want_l = torch.func.jacfwd(
                lambda d: residual_one(zero6, d, k, p))(zero3).to(torch.float32)
            scale = want_p.abs().max().item()
            torch.testing.assert_close(Jp[k, p], want_p, rtol=1e-3,
                                       atol=1e-5 * scale)
            torch.testing.assert_close(Jl[k, p], want_l, rtol=1e-3,
                                       atol=1e-5 * scale)


def test_w_rel_forms_and_missing_prior_agree():
    tprob, _, _ = _windows(range(2), 6, 32, None)
    B, K = 2, 6
    ref = tba.solve_ba(tprob, TCFG.camera, TCFG.vio, iters=2)
    for w in (torch.tensor(100.0), torch.full((B,), 100.0),
              torch.full((B, K - 1), 100.0)):
        out = tba.solve_ba(tprob._replace(w_rel=w), TCFG.camera, TCFG.vio,
                           iters=2)
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
    zero_prior = tprob._replace(pt_prior_w=torch.zeros(B, 32))
    out = tba.solve_ba(zero_prior, TCFG.camera, TCFG.vio, iters=2)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    # iters=None takes the configuration's count
    full = tba.solve_ba(tprob, TCFG.camera, TCFG.vio)
    eight = tba.solve_ba(tprob, TCFG.camera, TCFG.vio, iters=TCFG.vio.gn_iters)
    assert torch.equal(full.kf_pos, eight.kf_pos)


def test_a_nan_window_does_not_leak_into_another():
    tprob, _, _ = _windows(range(3), 6, 32, None)
    bad = tprob._replace(obs_uv=tprob.obs_uv.clone())
    bad.obs_uv[1] = float("nan")
    out = tba.solve_ba(bad, TCFG.camera, TCFG.vio, iters=3)
    ref = tba.solve_ba(tprob, TCFG.camera, TCFG.vio, iters=3)
    for i in (0, 2):
        for a, b in zip(out, ref):
            torch.testing.assert_close(a[i], b[i], rtol=0, atol=1e-6)
    assert not torch.isfinite(out.final_cost[1])


def test_bench_windows_stay_finite_and_the_cost_does_not_rise():
    prob = ba_problems.bench_windows(4, 16, 192, "cpu")
    assert prob.obs_uv.shape == (4, 16, 192, 2) and prob.pt_prior_w is None
    assert 0.3 < prob.obs_w.mean().item() < 0.5
    first = tba.solve_ba(prob, TCFG.camera, TCFG.vio, iters=1)
    out = tba.solve_ba(prob, TCFG.camera, TCFG.vio, iters=8)
    assert all(torch.isfinite(x).all() for x in out)
    assert (out.final_cost <= first.final_cost).all()


def test_flop_count_equals_the_benchmarks():
    spec = importlib.util.spec_from_file_location(
        "bench_for_test", Path(__file__).resolve().parents[1] / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    for K, P in ((16, 192), (10, 48), (24, 512)):
        assert ba_problems.ba_flops_per_iter(K, P) == \
            bench._ba_flops_per_iter(K, P)


def test_plain_solver_takes_float64():
    """The float64 plain solve, the reference the float32 solvers are held
    against on the card, agrees with the float32 one within the solvers'
    tolerance and keeps its dtype; mixed dtypes are refused."""
    tprob, _, _ = _windows([0, 1], 6, 40, 50.0)
    p64 = tba.BAProblem(*(t.double() if torch.is_tensor(t) else t
                          for t in tprob))
    r32 = tba.solve_ba_plain(tprob, TCFG.camera, TCFG.vio, iters=6)
    r64 = tba.solve_ba_plain(p64, TCFG.camera, TCFG.vio, iters=6)
    assert all(x.dtype == torch.float64 for x in r64)
    assert (r32.kf_pos - r64.kf_pos).abs().max() <= 2e-4
    assert (r32.kf_quat - r64.kf_quat).abs().max() <= 2e-5
    assert (r32.points - r64.points).abs().max() <= 1e-3
    with pytest.raises(TypeError):
        tba.solve_ba_plain(p64._replace(obs_z=tprob.obs_z), TCFG.camera,
                           TCFG.vio)
    with pytest.raises(TypeError):
        tba.solve_ba(p64, TCFG.camera, TCFG.vio)


def test_solve_ba_checks_its_input():
    tprob, _, _ = _windows([0], 6, 32, None)
    with pytest.raises(ValueError):
        tba.solve_ba(tprob._replace(kf_pos=tprob.kf_pos[0]), TCFG.camera,
                     TCFG.vio)
    with pytest.raises(ValueError):
        tba.solve_ba(tprob._replace(rel_dp=tprob.rel_dp[:, :-1]), TCFG.camera,
                     TCFG.vio)
    with pytest.raises(TypeError):
        tba.solve_ba(tprob._replace(points=tprob.points.double()),
                     TCFG.camera, TCFG.vio)


def test_problem_and_result_carry_across():
    """JAX problems and results convert into the port and back as numpy."""
    jprob, *_ = j_make_problem(seed=2)
    jbatch = jax.tree_util.tree_map(lambda x: jnp.asarray(x)[None], jprob)
    tprob = interop.from_numpy_tree(jbatch, "cpu")
    assert isinstance(tprob, tba.BAProblem) and tprob.pt_prior_w is None
    back = interop.to_numpy_tree(tprob)
    for f in jprob._fields[:-1]:
        np.testing.assert_array_equal(getattr(back, f),
                                      np.asarray(getattr(jbatch, f)))
    jres = jax.vmap(lambda p: jba.solve_ba(p, JCFG.camera, JCFG.vio,
                                           iters=2))(jbatch)
    tres = interop.from_numpy_tree(jres, "cpu")
    assert isinstance(tres, tba.BAResult)
    out = tba.solve_ba(tprob, TCFG.camera, TCFG.vio, iters=2)
    np.testing.assert_allclose(out.kf_pos.numpy(), tres.kf_pos.numpy(),
                               atol=2e-4)
