"""The VIO waypoint source's Procrustes flips, and the check that holds the
port's VIO waypoints against the JAX fixture's where those flips tie.

``procrustes_align_2d`` aligns the teach VIO track to GT under the best of
four axis flips.  On a straight, axis-aligned teach (both routes of
``tests/data/torch_ours_campaign_fixture.npz``) the flips about the line
fit equally well: their mean errors agree to float64 rounding, while the
mirror images lie centimetres apart.  So the last bits of the VIO track
decide which image becomes the waypoints, and ``chip_smoke.py``'s
``waypoint_flip_check`` accepts the port's waypoints under any flip that
ties on the fixture's own track (``chip_smoke.PROCRUSTES_TIE_GAP_M``),
within ``FIX_VIO_ATOL_M`` of the fixture's track aligned under that same
flip.  A flip that does not tie is still rejected, as is a gap above
``FIX_VIO_ATOL_M``.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

from nclt_slam_tpu_torch import config as tcfg
from nclt_slam_tpu_torch.eval import metrics as tm

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

FIXTURE = REPO / "tests" / "data" / "torch_ours_campaign_fixture.npz"
PLANNER = tcfg.ours().planner


def align_before(vio_xy, gt_xy):
    """``procrustes_align_2d`` as it was written before its flips were
    split out (and as the JAX package writes it)."""
    if len(vio_xy) < 2:
        return np.asarray(gt_xy[: len(vio_xy)])
    xg, yg = gt_xy[:, 0], gt_xy[:, 1]
    cxg, cyg = xg.mean(), yg.mean()
    dxg, dyg = xg - cxg, yg - cyg
    best, best_mean = None, np.inf
    for fx, fy in ((1, 1), (-1, 1), (1, -1), (-1, -1)):
        xv, yv = vio_xy[:, 0] * fx, vio_xy[:, 1] * fy
        dxv, dyv = xv - xv.mean(), yv - yv.mean()
        a = (dxv * dxg + dyv * dyg).sum()
        b = (dxv * dyg - dyv * dxg).sum()
        th = np.arctan2(b, a)
        c, s = np.cos(th), np.sin(th)
        rx = c * dxv - s * dyv + cxg
        ry = s * dxv + c * dyv + cyg
        err = np.hypot(rx - xg, ry - yg).mean()
        if err < best_mean:
            best, best_mean = np.stack([rx, ry], -1), err
    return best


@pytest.fixture(scope="module")
def fx():
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


def fixture_traces(fx):
    return fx["teach_gt_xy"], fx["teach_vio_xy"], fx["teach_done"]


def curved_traces(seed: int, n: int = 150):
    """Two routes along arcs of a 15 m circle with a drifting VIO track:
    (gt_xy, vio_xy, done), float32 like the rollout's traces."""
    rng = np.random.RandomState(seed)
    gt, vio = [], []
    for r in range(2):
        th = np.linspace(0.0, 1.2 + 0.3 * r, n)
        g = np.stack([15.0 * np.cos(th) + 20.0 * r, 15.0 * np.sin(th)], -1)
        v = g + np.cumsum(rng.normal(0.0, 0.002, g.shape), 0) + [1.0, -2.0]
        gt.append(g)
        vio.append(v)
    return (np.asarray(gt, np.float32), np.asarray(vio, np.float32),
            np.zeros((2, n), bool))


def own_waypoints(traces):
    wps, n, _ = chip_smoke.flip_waypoints(*traces, PLANNER)
    return wps, n


def tracks(traces):
    gt, vio, done = traces
    rng = np.random.RandomState(0)
    out = [(vio[i][~done[i]], gt[i][~done[i]]) for i in range(len(gt))]
    for dt in (np.float32, np.float64):
        for n in (1, 2, 7, 150):
            g = np.cumsum(rng.normal(size=(n, 2)), 0)
            out.append(((g + rng.normal(0.0, 0.1, g.shape)).astype(dt),
                        g.astype(dt)))
            out.append(((g[:, ::-1] * [1, -1]).astype(dt), g.astype(dt)))
    return out


@pytest.mark.parametrize("kind", ["fixture", "curved"])
def test_procrustes_align_equals_its_previous_form(fx, kind):
    traces = fixture_traces(fx) if kind == "fixture" else curved_traces(3)
    for vio, gt in tracks(traces):
        a, b = tm.procrustes_align_2d(vio, gt), align_before(vio, gt)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_fixture_flips_tie(fx):
    """On both fixture routes all four flips' mean errors (float64) lie
    within the tie gap, while the two mirror images are further apart than
    the waypoint tolerance."""
    gt, vio, done = fixture_traces(fx)
    for i in range(len(gt)):
        v, g = vio[i][~done[i]], gt[i][~done[i]]
        tied, errs = chip_smoke.procrustes_ties(v, g)
        assert tied == [0, 1, 2, 3], (i, errs)
        assert max(errs) - min(errs) <= chip_smoke.PROCRUSTES_TIE_GAP_M
        aligned, _ = tm.procrustes_flips_2d(v, g)
        assert np.abs(aligned[0] - aligned[1]).max() > chip_smoke.FIX_VIO_ATOL_M


def test_fixture_waypoints_are_its_own_tracks(fx):
    wps, n = own_waypoints(fixture_traces(fx))
    assert np.array_equal(n, fx["n_wps"])
    assert np.array_equal(wps[:, :n.max()], fx["wps"][:, :n.max()])


def nudged_until_the_flip_changes(traces):
    """The fixture's VIO track moved by a few micrometres, seed by seed,
    until the port would keep another flip than the fixture on a route."""
    gt, vio, done = traces
    _, _, ref_flips = chip_smoke.flip_waypoints(*traces, PLANNER)
    for seed in range(200):
        rng = np.random.RandomState(seed)
        moved = (vio + rng.normal(0.0, 2e-6, vio.shape)).astype(np.float32)
        _, _, flips = chip_smoke.flip_waypoints(gt, moved, done, PLANNER)
        if flips != ref_flips:
            return (gt, moved, done), flips, ref_flips
    raise AssertionError("no nudge changed a flip")


def test_a_tied_flip_is_accepted(fx):
    """A VIO track a few micrometres from the fixture's that keeps the
    mirror image: its waypoints lie centimetres from the fixture's, and
    the check accepts them as the tied flip's."""
    ref = fixture_traces(fx)
    port, flips, ref_flips = nudged_until_the_flip_changes(ref)
    wps, _ = own_waypoints(port)
    n = int(fx["n_wps"].max())
    assert np.abs(wps[:, :n] - fx["wps"][:, :n]).max() > \
        chip_smoke.FIX_VIO_ATOL_M
    report, fails, kept = chip_smoke.waypoint_flip_check(
        port, ref, fx["wps"], fx["n_wps"], PLANNER)
    assert not fails, fails
    assert kept == ref_flips and report["flip_port"] == flips
    assert report["flip_tie"] == [True, True]
    assert report["vio_wps_max_err_m"] <= chip_smoke.FIX_VIO_ATOL_M


def test_a_curved_track_has_one_alignment():
    """On a curve only the flips that are one rotation of each other tie:
    (1, 1) with (-1, -1) and (1, -1) with (-1, 1)."""
    gt, vio, done = curved_traces(3)
    for i in range(len(gt)):
        tied, errs = chip_smoke.procrustes_ties(vio[i], gt[i])
        assert tied == [0, 3], (i, errs)
        assert min(errs[1], errs[2]) - errs[0] > 1e3 * \
            chip_smoke.PROCRUSTES_TIE_GAP_M


def test_a_curved_track_passes_against_itself():
    ref = curved_traces(3)
    wps, n = own_waypoints(ref)
    report, fails, _ = chip_smoke.waypoint_flip_check(ref, ref, wps, n,
                                                      PLANNER)
    assert not fails and report["vio_wps_max_err_m"] == 0.0
    assert report["flip_tie"] == [False, False]


def test_a_flip_that_does_not_tie_is_rejected():
    """The port's VIO track mirrored (x negated) on a curved route keeps a
    mirroring flip, which does not tie on the fixture's track."""
    ref = curved_traces(3)
    wps, n = own_waypoints(ref)
    gt, vio, done = ref
    port = (gt, vio * np.array([-1.0, 1.0], np.float32), done)
    report, fails, _ = chip_smoke.waypoint_flip_check(port, ref, wps, n,
                                                      PLANNER)
    assert all(k in (1, 2) for k in report["flip_port"])
    assert all(k in (0, 3) for k in report["flip_fixture"])
    assert any("does not tie" in f for f in fails), fails


def test_a_gap_above_the_tolerance_is_rejected(fx):
    """Under a tied flip, waypoints further than FIX_VIO_ATOL_M from the
    fixture's are still rejected, on the straight fixture and on a curve."""
    for ref, wps, n in ((fixture_traces(fx), fx["wps"], fx["n_wps"]),
                        (curved_traces(3), *own_waypoints(curved_traces(3)))):
        gt, vio, done = ref
        port = (gt, (vio * np.float32(1.0003)).astype(np.float32), done)
        report, fails, _ = chip_smoke.waypoint_flip_check(port, ref, wps, n,
                                                          PLANNER)
        assert report["vio_wps_max_err_m"] > chip_smoke.FIX_VIO_ATOL_M
        assert any("under the same flip" in f for f in fails), fails
