"""The port's pose-graph half (``nclt_slam_tpu_torch/datasets/slam/
loop_closure.py``) against the JAX package on the CPU.

Inputs are the JAX package's own two-lap test graph (``tests/test_pgo.py``:
K = 240 noisy-odometry poses, 4 valid and 2 invalid loop slots with exact
measurements), made from its numpy seed and handed to both packages.

Tolerances: the reduced solvers (the port's ``optimize_pgo_plain``, K4's
function, against JAX's interpret-mode K4 and its dense XLA reduced solve)
agree within 1e-3 m / rad: tighter than the 1e-2 that
``tests/test_pgo.py::test_pgo_pallas_matches_xla_on_reduced`` allows
between JAX's own two, because the port solves with a pivoted LU where the
TPU kernel runs an unpivoted float32 Gauss-Jordan.  The full-graph and
route-level solves agree within 1e-3 m; the fused route, which JAX solves
with its dense atan2-wrap optimizer and the port with K4's floor-wrap
function, within the same.

``test_blocked_cholesky_rehearsal`` rehearses the arithmetic of the CUDA
kernel (``csrc/pgo.cu``: an unpivoted float32 Cholesky in 32-column panels,
the diagonal guard 1e-20) on the CPU, on ``chip_smoke.py``'s four check
graphs, against ``optimize_pgo_plain`` in float64 within ``PGO_ATOL``.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from test_pgo import _two_lap_graph  # noqa: E402

from chip_smoke import PGO_ATOL, PGO_ITERS, pgo_graphs  # noqa: E402

from nclt_slam_tpu.datasets.slam import loop_closure as jlc  # noqa: E402
from nclt_slam_tpu.ops.pgo_pallas import optimize_pgo_pallas  # noqa: E402
from nclt_slam_tpu_torch import interop  # noqa: E402
from nclt_slam_tpu_torch.datasets.slam import loop_closure as tlc  # noqa: E402

CPU = torch.device("cpu")
ATOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port on one CPU thread: at these sizes torch's intra-op threads
    cost more than they give (an ICP iteration of 128 points against a
    1280-point map took ~2 ms on one thread and ~50 ms on eight, on an
    8-core CPU host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(graph):
    return interop.from_numpy_tree(graph, CPU)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def test_dense_matches_jax():
    graph, gt = _two_lap_graph()
    want = np.asarray(jlc.optimize_pose_graph(graph, iters=15))
    got = tlc.optimize_pose_graph(_port(graph), iters=15).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_reduce_and_expand_match_jax():
    graph, _ = _two_lap_graph()
    j_red, j_w, j_junc = jlc.reduce_pose_graph(graph, 1.0)
    t_red, t_w, t_junc = tlc.reduce_pose_graph(_port(graph), 1.0)
    np.testing.assert_array_equal(t_junc, j_junc)
    np.testing.assert_array_equal(t_w.numpy(), np.asarray(j_w))
    for name in t_red._fields:
        np.testing.assert_array_equal(_np(getattr(t_red, name)),
                                      np.asarray(getattr(j_red, name)))
    opt = np.asarray(jax.jit(lambda g, w: jlc.optimize_pose_graph(
        g, iters=15, odo_w=w))(j_red, j_w))
    np.testing.assert_array_equal(
        tlc.expand_reduced(_port(graph), t_junc, torch.from_numpy(opt)),
        jlc.expand_reduced(graph, j_junc, opt))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_matches_jax_reduced_solvers(dtype):
    """K4's plain version against JAX's interpret-mode K4 and its dense
    reduced solve, in float32 and float64."""
    graph, _ = _two_lap_graph()
    reduced, red_w, _ = jlc.reduce_pose_graph(graph, 1.0)
    pallas = np.asarray(optimize_pgo_pallas(reduced, red_w, iters=15,
                                            interpret=True))
    xla = np.asarray(jax.jit(lambda g, w: jlc.optimize_pose_graph(
        g, iters=15, odo_w=w))(reduced, red_w))
    t_red = _port(reduced)
    t_red = t_red._replace(poses=t_red.poses.to(dtype),
                           odo_meas=t_red.odo_meas.to(dtype),
                           loop_meas=t_red.loop_meas.to(dtype))
    got = tlc.optimize_pgo_plain(t_red, torch.from_numpy(
        np.asarray(red_w)).to(dtype), iters=15)
    assert got.dtype == dtype
    got = got.double().numpy()
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, xla, atol=ATOL, rtol=0)
    # the entry point sends CPU tensors to the plain version
    if dtype == torch.float32:
        np.testing.assert_array_equal(
            tlc.optimize_pgo(t_red, torch.from_numpy(np.asarray(red_w)),
                             iters=15).numpy(), got.astype(np.float32))


@pytest.mark.parametrize("backend", ["fused", "xla", "pallas"])
def test_fast_routes_match_jax(backend):
    """The port's fused and host routes against JAX's: "fused" against
    JAX's fused program, the host routes against JAX's "xla" route."""
    graph, gt = _two_lap_graph()
    want = np.asarray(jlc.optimize_pose_graph_fast(
        graph, iters=15, backend="fused" if backend == "fused" else "xla"))
    got = tlc.optimize_pose_graph_fast(_port(graph), iters=15,
                                       backend=backend)
    assert got.shape == (240, 3) and got.device == CPU
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # and both close the loop against the ground truth
    err = np.linalg.norm(got.numpy()[:, :2] - gt[:, :2], axis=1).mean()
    open_err = np.linalg.norm(np.asarray(graph.poses)[:, :2] - gt[:, :2],
                              axis=1).mean()
    assert err < 0.75 * open_err


@pytest.mark.parametrize("backend", ["fused", "xla"])
def test_no_valid_loop_keeps_chain(backend):
    graph, _ = _two_lap_graph()
    graph = graph._replace(loop_valid=jnp.zeros_like(graph.loop_valid))
    want = np.asarray(jlc.optimize_pose_graph_fast(graph, iters=5,
                                                   backend=backend))
    got = tlc.optimize_pose_graph_fast(_port(graph), iters=5,
                                       backend=backend).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    d = np.linalg.norm(got[:, :2] - np.asarray(graph.poses)[:, :2], axis=1)
    assert d.max() < 0.05, d.max()


def test_fused_duplicate_last_pose_last_copy_wins(monkeypatch):
    """The padded junction set names pose K-1 once per padded copy; the
    final write takes the last copy, as XLA on the CPU applies JAX's
    ``out.at[junctions].set``.  The solver is replaced by one that gives
    every copy a different value, so the winner is visible."""
    graph, _ = _two_lap_graph()
    seen = {}

    def marked(reduced, red_w, iters, lc_w, damping, prior_w=1e4,
               site="other"):
        seen["Kr"] = reduced.poses.shape[0]
        seen["site"] = site
        return reduced.poses + torch.arange(
            reduced.poses.shape[0], dtype=torch.float32)[:, None]

    monkeypatch.setattr(tlc, "optimize_pgo", marked)
    out = tlc.optimize_pose_graph_fast(_port(graph), iters=1).numpy()
    Kr = seen["Kr"]
    assert Kr == 2 + 2 * 6 and seen["site"] == "fused"
    # 4 valid loops: 2 + 8 distinct junctions, the other 4 slots copies of
    # K-1 at the sorted tail; the last row of the reduced solve wins
    np.testing.assert_allclose(out[-1], np.asarray(graph.poses)[-1] + Kr - 1,
                               rtol=0, atol=1e-4)
    # JAX's program writes the same rows
    base = torch.from_numpy(np.zeros((5, 2), np.float32))
    got = tlc._set_last(base, torch.tensor([1, 4, 4, 4]),
                        torch.arange(8, dtype=torch.float32).reshape(4, 2))
    want = jnp.zeros((5, 2)).at[jnp.array([1, 4, 4, 4])].set(
        jnp.arange(8, dtype=jnp.float32).reshape(4, 2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wraps_agree_off_pi():
    a = torch.linspace(-20.0, 20.0, 4001)
    a = a[(a.abs() % np.pi).gt(1e-3) & (a.abs() % np.pi).lt(np.pi - 1e-3)]
    np.testing.assert_allclose(tlc._wrap_floor(a).numpy(),
                               tlc._wrap_atan2(a).numpy(), atol=2e-5)


def test_optimize_pgo_rejects_bad_graphs():
    graph, _ = _two_lap_graph()
    g = _port(graph)
    with pytest.raises(ValueError):
        tlc.optimize_pgo(g._replace(odo_meas=g.odo_meas[:-1]), 1.0)
    with pytest.raises(ValueError):
        tlc.optimize_pgo(g, torch.ones(5))
    with pytest.raises(ValueError):
        tlc.optimize_pose_graph_fast(g, backend="dense")


PANEL = 32             # csrc/pgo.cu's kB


def _blocked_cholesky_solve(H, rhs):
    """Solve H x = rhs as csrc/pgo.cu does, in H's dtype: H padded to a
    multiple of PANEL with an identity block; per panel, the diagonal tile
    factored column by column (a diagonal <= 1e-20 or NaN taken as 1,
    columns scaled by the diagonal's reciprocal), the tile's part of
    L y = rhs and the rows below it (x L_JJ^T = a) solved by substitution,
    the rest of rhs and the trailing lower triangle updated; then
    L^T x = y panel by panel from the last."""
    n = H.shape[0]
    npad = -(-n // PANEL) * PANEL
    A = torch.eye(npad, dtype=H.dtype)
    A[:n, :n] = torch.tril(H)
    r = torch.zeros(npad, dtype=H.dtype)
    r[:n] = rhs
    one = torch.ones((), dtype=H.dtype)
    rinv = torch.zeros(npad, dtype=H.dtype)
    for t0 in range(0, npad, PANEL):
        d, rest = slice(t0, t0 + PANEL), slice(t0 + PANEL, npad)
        D = torch.tril(A[d, d])
        for c in range(PANEL):
            piv = D[c, c] if D[c, c] > 1e-20 else one
            D[c, c] = torch.sqrt(piv)
            rinv[t0 + c] = one / D[c, c]
            D[c + 1:, c] *= rinv[t0 + c]
            D[c + 1:, c + 1:] -= torch.outer(D[c + 1:, c], D[c + 1:, c])
        D = torch.tril(D)
        A[d, d] = D
        X = A[rest, d].clone()
        for c in range(PANEL):
            r[t0 + c] *= rinv[t0 + c]
            r[t0 + c + 1:t0 + PANEL] -= D[c + 1:, c] * r[t0 + c]
            X[:, c] *= rinv[t0 + c]
            X[:, c + 1:] -= torch.outer(X[:, c], D[c + 1:, c])
        A[rest, d] = X
        for c in range(PANEL):
            r[rest] -= X[:, c] * r[t0 + c]
        A[rest, rest] -= X @ X.T
    for t0 in range(npad - PANEL, -1, -PANEL):
        d, head = slice(t0, t0 + PANEL), slice(0, t0)
        for c in range(PANEL - 1, -1, -1):
            r[t0 + c] *= rinv[t0 + c]
            r[t0:t0 + c] -= A[t0 + c, t0:t0 + c] * r[t0 + c]
        r[head] -= A[d, head].T @ r[d]
    return r[:n]


@pytest.mark.parametrize("name", ["two_lap", "tool_shape", "no_valid_loop",
                                  "large"])
def test_blocked_cholesky_rehearsal(name):
    """PGO_ITERS Gauss-Newton steps of K4's function, each solved by the
    kernel's float32 blocked Cholesky, within PGO_ATOL of the plain version
    in float64: unpivoted float32 is accurate enough on these systems."""
    graph, w = pgo_graphs(CPU)[name]
    ei, ej, meas, wts = tlc._edges(graph, w, 10.0)
    x = graph.poses
    for _ in range(PGO_ITERS):
        H, g = tlc._normal_equations(x, graph.poses[0], ei, ej, meas, wts,
                                     1e4, 1e-3, tlc._wrap_floor)
        x = x + _blocked_cholesky_solve(H, -g).reshape(-1, 3)
    assert x.dtype == torch.float32 and torch.isfinite(x).all()
    g64 = graph._replace(poses=graph.poses.double(),
                         odo_meas=graph.odo_meas.double(),
                         loop_meas=graph.loop_meas.double())
    ref = tlc.optimize_pgo_plain(g64, w.double(), iters=PGO_ITERS)
    err = (x.double() - ref).abs().max().item()
    print(f"rehearsal {name}: {err:.3e} from float64 (limit {PGO_ATOL})")
    assert err <= PGO_ATOL, err


def test_blocked_cholesky_solves_spd_system():
    """The rehearsal's solver on a random SPD system of a tail panel
    (n = 70, padded to 96) matches a float64 solve."""
    rng = np.random.RandomState(0)
    M = rng.normal(size=(70, 70))
    H = M @ M.T + 70 * np.eye(70)
    b = rng.normal(size=70)
    got = _blocked_cholesky_solve(torch.from_numpy(H), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.linalg.solve(H, b),
                               rtol=0, atol=1e-10)
