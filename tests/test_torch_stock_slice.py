"""The stock slice — the stock Nav2 baseline (``baselines.configs.
stock_nav2()``: RegulatedPurePursuit with its recovery cycle, the stock
waypoint-following dispatcher, VIO without anchors) and the encoder-only
ablation (``config.encoder_only()``) — against the JAX package.

- ``rpp_tick`` on the JAX unit cases of ``tests/test_stock_baseline.py``,
  batched over routes (full, half and no progress along one straight path,
  1200 ticks): every tick's phase, recovery count and anchor flag equal,
  commands and float state within ``RPP_ATOL``.
- The stock ``dispatch_plan`` / ``dispatch_move`` cases of that file: the
  resulting states equal (integers and flags exactly, floats within
  ``RPP_ATOL``).
- ``stock_project_waypoints`` move and drop: exactly equal.
- ``expand_for_ablations`` on a two-route batch: every tensor equal.
- ``repeat_step`` step parity for both modes on the miniature scene/route of
  ``tests/test_rollout_e2e.py``, off the port's VIO teach (as the ours slice
  test makes it), two routes (the drop on the path, and none), from one
  key: every discrete sequence equal and the poses within ``POSE_ATOL`` over
  ``STOCK_TICKS`` / ``ENCODER_TICKS``.  The relay's alignment window is cut
  to 20 samples so the stock robots leave the bring-up hold at tick 19.
- ``tools/torch_calibrate``'s teach-drift and anchor-outcome counting, on
  the ours fixture's traces, against ``tools/calibrate.run``'s own.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).parent))
sys.path.insert(0, str(REPO / "tools"))
from test_rollout_e2e import pack_test_route, small_config, straight_route, tiny_scene  # noqa: E402
from test_torch_ours_slice import DISCRETE, POSE_ATOL, batch1, configs  # noqa: E402

from nclt_slam_tpu import config as jcfg  # noqa: E402
from nclt_slam_tpu.baselines import configs as jbase  # noqa: E402
from nclt_slam_tpu.control import rpp as jrpp  # noqa: E402
from nclt_slam_tpu.planning import dispatcher as jdisp  # noqa: E402
from nclt_slam_tpu.rollout import campaign as jcamp  # noqa: E402
from nclt_slam_tpu.rollout.repeat import init_repeat_carry  # noqa: E402
from nclt_slam_tpu.rollout.repeat import repeat_step as j_repeat_step  # noqa: E402
from nclt_slam_tpu_torch import config as tcfg  # noqa: E402
from nclt_slam_tpu_torch import interop  # noqa: E402
from nclt_slam_tpu_torch.baselines import configs as tbase  # noqa: E402
from nclt_slam_tpu_torch.control import rpp as trpp  # noqa: E402
from nclt_slam_tpu_torch.planning import dispatcher as tdisp  # noqa: E402
from nclt_slam_tpu_torch.rollout import campaign as tcamp  # noqa: E402
from nclt_slam_tpu_torch.rollout.repeat import run_repeat as t_run_repeat  # noqa: E402
from nclt_slam_tpu_torch.rollout.teach import run_teach as t_run_teach  # noqa: E402

torch.set_num_threads(1)

RPP_ATOL = 1e-6
RPP_TICKS = 1200
SPEEDS = (1.0, 0.5, 0.0)      # progress per commanded metre: full, half, pinned
TEACH_TICKS = 100
STOCK_TICKS = 60
ENCODER_TICKS = 100
ALIGN_WINDOW = 20
STOCK_DISCRETE = DISCRETE + ("goal_blocked", "plan_fails", "recovery_phase")


def _unbatch(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x[0]),
                                  interop.to_numpy_tree(tree))


def _assert_state_equal(got, want, atol=RPP_ATOL):
    """A port state of one route against a JAX state: integers and flags
    exactly, floats within ``atol``."""
    for f in want._fields:
        g, w = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=atol, err_msg=f)
        else:
            assert np.array_equal(g, w), f


# ---------------------------------------------------------------- RPP ----

def straight_path(n=32, step=0.5):
    xy = np.zeros((64, 2), np.float32)
    xy[:n, 0] = np.arange(n) * step
    xy[n:] = xy[n - 1]
    return xy, n


@pytest.fixture(scope="module")
def rpp_runs():
    """The straight-path cases of the JAX file as one batch of three routes
    (full, half and no progress), both packages fed the same positions."""
    path, n = straight_path()
    B = len(SPEEDS)
    speeds = np.asarray(SPEEDS, np.float32)[:, None]
    jcfg_r, tcfg_r = jcfg.RppConfig(), tcfg.RppConfig()
    jtick = jax.jit(jax.vmap(
        lambda st, pos, t: jrpp.rpp_tick(st, pos, jnp.float32(0.0),
                                         jnp.asarray(path), jnp.int32(n),
                                         jnp.array(True), t, jcfg_r),
        in_axes=(0, 0, None)))
    jst = jax.tree_util.tree_map(lambda x: jnp.stack([x] * B),
                                 jrpp.init_rpp())
    tst = trpp.init_rpp(B, "cpu")
    tpath = torch.from_numpy(path)[None].expand(B, -1, -1)
    tn = torch.full((B,), n, dtype=torch.int32)
    active = torch.ones(B, dtype=torch.bool)
    pos = np.zeros((B, 2), np.float32)
    rows = []
    for t in range(RPP_TICKS):
        t_now = np.float32(t * 0.1)
        jst, jv, jw = jtick(jst, jnp.asarray(pos), jnp.float32(t_now))
        tst, tv, tw = trpp.rpp_tick(tst, torch.from_numpy(pos),
                                    torch.zeros(B), tpath, tn, active,
                                    torch.tensor(t_now), tcfg_r)
        rows.append((np.asarray(jv), np.asarray(jw), tv.numpy(), tw.numpy(),
                     jax.tree_util.tree_map(np.asarray, jst),
                     interop.to_numpy_tree(tst)))
        step = np.stack([np.asarray(jv) * np.float32(0.1),
                         np.zeros(B, np.float32)], -1)
        pos = pos + step * speeds
    return rows


def test_rpp_matches_jax_every_tick(rpp_runs):
    for t, (jv, jw, tv, tw, jst, tst) in enumerate(rpp_runs):
        np.testing.assert_allclose(tv, jv, atol=RPP_ATOL, err_msg=f"v {t}")
        np.testing.assert_allclose(tw, jw, atol=RPP_ATOL, err_msg=f"w {t}")
        for f in ("phase", "recovery_count", "anchor_set"):
            assert np.array_equal(getattr(tst, f), getattr(jst, f)), (f, t)
        for f in ("prev_v", "anchor_xy", "anchor_t", "phase_until"):
            np.testing.assert_allclose(getattr(tst, f), getattr(jst, f),
                                       atol=RPP_ATOL, err_msg=f"{f} {t}")


def test_rpp_drives_straight(rpp_runs):
    *_, tv, tw, _, _ = rpp_runs[19]
    assert tv[0] > 0.5 and abs(tw[0]) < 0.1


def test_rpp_no_recovery_while_progressing(rpp_runs):
    assert int(rpp_runs[399][5].recovery_count[1]) == 0


def test_rpp_stall_cycles_every_recovery(rpp_runs):
    phases = {int(r[5].phase[2]) for r in rpp_runs}
    assert int(rpp_runs[-1][5].recovery_count[2]) >= 2
    assert phases >= {trpp.PHASE_NONE, trpp.PHASE_SPIN, trpp.PHASE_BACKUP,
                      trpp.PHASE_WAIT}
    spin = [(r[2][2], r[3][2]) for r in rpp_runs
            if r[5].phase[2] == trpp.PHASE_SPIN]
    backup = [r[2][2] for r in rpp_runs if r[5].phase[2] == trpp.PHASE_BACKUP]
    assert spin and all(v == 0.0 and w > 0.5 for v, w in spin)
    assert backup and all(v < 0.0 for v in backup)


def test_rpp_curvature_regulation_matches_jax():
    """A carrot 90 degrees to the side: the tight radius regulates."""
    path = np.zeros((64, 2), np.float32)
    path[:, 1] = 2.0
    jst = jrpp.init_rpp()._replace(prev_v=jnp.float32(0.8))
    jst, jv, jw = jrpp.rpp_tick(jst, jnp.zeros(2), jnp.float32(0.0),
                                jnp.asarray(path), jnp.int32(8),
                                jnp.array(True), jnp.float32(0.0),
                                jcfg.RppConfig())
    tst = trpp.init_rpp(1, "cpu")._replace(prev_v=torch.tensor([0.8]))
    tst, tv, tw = trpp.rpp_tick(
        tst, torch.zeros(1, 2), torch.zeros(1), torch.from_numpy(path)[None],
        torch.tensor([8], dtype=torch.int32), torch.ones(1, dtype=torch.bool),
        torch.tensor(0.0), tcfg.RppConfig())
    np.testing.assert_allclose([float(tv[0]), float(tw[0])],
                               [float(jv), float(jw)], atol=RPP_ATOL)
    assert float(tv[0]) > 0.2 and float(tw[0]) > 0.3
    _assert_state_equal(_unbatch(tst), jst)


# --------------------------------------------------------- dispatcher ----

def _wps(cfg, pts):
    wps = np.zeros((cfg.max_waypoints, 2), np.float32)
    wps[:len(pts)] = pts
    return wps


def _known(backend):
    if backend == "jax":
        zero = jnp.zeros(1)
        return zero[:, None].repeat(2, 1), zero, jnp.zeros(1, bool)
    return (torch.zeros(1, 1, 2), torch.zeros(1, 1),
            torch.zeros(1, 1, dtype=torch.bool))


def _init(backend, cfg, wps, n, **kw):
    st = jdisp.init_dispatch(jnp.asarray(wps), n, cfg)
    st = st._replace(**{k: jnp.asarray(v) for k, v in kw.items()})
    if backend == "jax":
        return st
    return batch1(st)


def _move(backend, st, robot, cfg):
    if backend == "jax":
        return jdisp.dispatch_move(st, jnp.asarray(robot), *_known("jax"),
                                   cfg)
    return tdisp.dispatch_move(st, torch.tensor([robot]), *_known("torch"),
                               cfg)


def _stock_planner(backend):
    return (jbase if backend == "jax" else tbase).stock_nav2().planner


def case_no_timeout_skip(backend):
    """No per-WP timeout: an unreachable WP blocks for good."""
    cfg = _stock_planner(backend)
    st = _init(backend, cfg, _wps(cfg, [[0, 0], [10, 0], [20, 0], [30, 0]]),
               4, idx=np.int32(1), target=np.float32([10.0, 0.0]))
    for _ in range(5):
        st = st._replace(ticks_on_wp=st.ticks_on_wp * 0 + 10 ** 5)
        st = _move(backend, st, [0.0, 0.0], cfg)
    return st


def case_plan_fail_advances(backend):
    """Repeated plan failure aborts the goal; the next WP follows."""
    cfg = _stock_planner(backend)
    st = _init(backend, cfg, _wps(cfg, [[0, 0], [10, 0], [20, 0], [30, 0]]),
               4, idx=np.int32(1), target=np.float32([10.0, 0.0]),
               plan_fails=np.int32(cfg.max_plan_fails))
    return _move(backend, st, [0.0, 0.0], cfg)


def case_ours_still_times_out(backend):
    cfg = (jcfg if backend == "jax" else tcfg).DEFAULT.planner
    wps = np.zeros((cfg.max_waypoints, 2), np.float32)
    wps[:20, 0] = np.arange(20) * 10.0
    st = _init(backend, cfg, wps, 20, idx=np.int32(1),
               target=np.float32([10.0, 0.0]),
               ticks_on_wp=np.int32(cfg.goal_timeout_ticks))
    return _move(backend, st, [0.0, 0.0], cfg)


def case_goal_blocked_crawl_then_abort(backend):
    cfg = _stock_planner(backend)
    wps = _wps(cfg, [[0, 0], [10, 0], [20, 0], [30, 0]])
    st = _init(backend, cfg, wps, 4, idx=np.int32(1),
               target=np.float32([10.0, 0.0]), goal_blocked=np.bool_(True),
               plan_fails=np.int32(10 ** 4),
               blocked_ticks=np.int32(cfg.stock_abort_ticks - 5))
    idx = []
    for _ in range(4):
        st = _move(backend, st, [0.0, 0.0], cfg)
        st = st._replace(plan_fails=st.plan_fails * 0 + 10 ** 4)
        idx.append(int(np.asarray(st.idx).reshape(-1)[0]))
    for _ in range(4):
        st = _move(backend, st, [0.0, 0.0], cfg)
    assert idx == [1, 1, 1, 1] and int(np.asarray(st.idx).reshape(-1)[0]) == 2
    return st


def case_plannable_goal_moves_on(backend):
    cfg = _stock_planner(backend)
    st = _init(backend, cfg, _wps(cfg, [[0, 0], [10, 0], [20, 0], [30, 0]]),
               4, idx=np.int32(1), target=np.float32([10.0, 0.0]),
               goal_blocked=np.bool_(False), plan_fails=np.int32(10 ** 4))
    return _move(backend, st, [0.0, 0.0], cfg)


def _plan(backend, lethal_start):
    """``dispatch_plan`` of the stock planner (projection off) in a window
    centred on the origin, with a lethal blob under the robot or none."""
    stock = (jbase if backend == "jax" else tbase).stock_nav2()
    cfg = dataclasses.replace(stock.planner, enable_projection=False)
    map_cfg, W = stock.map, cfg.window
    wps = _wps(cfg, [[0, 0], [10, 0]])
    st = _init(backend, cfg, wps, 2, idx=np.int32(1),
               target=np.float32([10.0, 0.0]))
    r0 = int((0.0 - map_cfg.origin_y) / map_cfg.resolution) - W // 2
    c0 = int((0.0 - map_cfg.origin_x) / map_cfg.resolution) - W // 2
    cost = np.zeros((W, W), np.float32)
    if lethal_start:
        cost[W // 2 - 3: W // 2 + 3, W // 2 - 3: W // 2 + 3] = 99.0
    if backend == "jax":
        return jdisp.dispatch_plan(st, jnp.zeros(2), jnp.asarray(cost),
                                   jnp.int32(r0), jnp.int32(c0),
                                   *_known("jax"), map_cfg, cfg)
    return tdisp.dispatch_plan(
        st, torch.zeros(1, 2), torch.from_numpy(cost)[None],
        torch.tensor([r0], dtype=torch.int32),
        torch.tensor([c0], dtype=torch.int32), *_known("torch"), map_cfg,
        cfg)


def case_start_lethal_fails_planning(backend):
    st = _plan(backend, lethal_start=True)
    blocked = bool(np.asarray(st.goal_blocked).reshape(-1)[0])
    has_path = bool(np.asarray(st.has_path).reshape(-1)[0])
    assert blocked and not has_path
    return st


def case_clear_start_plans(backend):
    st = _plan(backend, lethal_start=False)
    assert bool(np.asarray(st.has_path).reshape(-1)[0])
    return st


DISPATCH_CASES = {
    "no_timeout_skip": (case_no_timeout_skip, 1),
    "plan_fail_advances": (case_plan_fail_advances, 2),
    "ours_still_times_out": (case_ours_still_times_out, 2),
    "goal_blocked_crawl_then_abort": (case_goal_blocked_crawl_then_abort, 2),
    "plannable_goal_moves_on": (case_plannable_goal_moves_on, 2),
    "start_lethal_fails_planning": (case_start_lethal_fails_planning, 1),
    "clear_start_plans": (case_clear_start_plans, 1),
}


@pytest.mark.parametrize("name", sorted(DISPATCH_CASES))
def test_stock_dispatcher_case_matches_jax(name):
    case, idx = DISPATCH_CASES[name]
    want = case("jax")
    got = case("torch")
    _assert_state_equal(_unbatch(got), want)
    assert int(got.idx[0]) == idx


# ------------------------------------------------- waypoint projection ----

def _grid_with_block(map_cfg, r0, r1, c0, c1):
    g = np.zeros((map_cfg.rows, map_cfg.cols), np.int8)
    g[r0:r1, c0:c1] = 2
    return g


@pytest.mark.parametrize("block,n_want", [((495, 506, 1045, 1056), 2),
                                         ((440, 560, 990, 1110), 1)],
                         ids=["move", "drop"])
def test_stock_project_waypoints_equals_jax(block, n_want):
    map_cfg = tcfg.MapConfig()
    g = _grid_with_block(map_cfg, *block)
    wps = np.zeros((8, 2), np.float32)
    wps[0] = [0.0, 0.0]
    wps[1] = [30.0, 30.0]
    got, n = tdisp.stock_project_waypoints(g, wps, 2, map_cfg)
    want, n_j = jdisp.stock_project_waypoints(g, wps, 2, jcfg.MapConfig())
    assert n == n_j == n_want
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if n_want == 2:
        assert 0.01 < np.hypot(*(got[0] - wps[0])) <= 2.1


def test_apply_stock_projection_equals_jax():
    """The campaign's per-route projection, a no-op but for stock."""
    map_cfg = tcfg.MapConfig()
    grids = np.stack([_grid_with_block(map_cfg, 495, 506, 1045, 1056),
                      _grid_with_block(map_cfg, 440, 560, 990, 1110)])
    wps = np.zeros((2, 8, 2), np.float32)
    wps[:, 1] = [30.0, 30.0]
    n = np.array([2, 2], np.int32)
    jw, jn = jcamp.apply_stock_projection(grids, wps, n, jbase.stock_nav2())
    tw, tn = tcamp.apply_stock_projection(
        torch.from_numpy(grids), torch.from_numpy(wps), torch.from_numpy(n),
        tbase.stock_nav2())
    assert np.array_equal(tw.numpy(), np.asarray(jw))
    assert tn.tolist() == np.asarray(jn).tolist() == [2, 1]
    same = tcamp.apply_stock_projection(torch.from_numpy(grids),
                                        torch.from_numpy(wps),
                                        torch.from_numpy(n), tcfg.ours())
    assert torch.equal(same[0], torch.from_numpy(wps))


# --------------------------------------------------------- ablations ----

def test_expand_for_ablations_matches_jax():
    cfg = small_config()
    packed, wps, n_wps = pack_test_route(straight_route(), cfg)
    scenes = [tiny_scene(drop_on_path=True), tiny_scene(drop_on_path=False)]

    def stack(trees):
        return jax.tree_util.tree_map(lambda *x: np.stack(
            [np.asarray(a) for a in x]), *trees)

    jdata = jcamp.CampaignData(stack(scenes), stack(scenes[::-1]),
                               stack([packed, packed]), ("a", "b"))
    grids = np.zeros((2, cfg.map.rows, cfg.map.cols), np.int8)
    grids[1, 5:9, 7:20] = 2
    w = np.stack([np.asarray(wps)] * 2)
    n = np.array([n_wps, n_wps - 1], np.int32)
    want = jcamp.expand_for_ablations(jdata, grids, w, n)
    tdata = interop.from_numpy_tree(jdata, "cpu")
    got = tcamp.expand_for_ablations(tdata, torch.from_numpy(grids),
                                     torch.from_numpy(w), torch.from_numpy(n))
    assert got[0].names == want[0].names == got[5] == want[5]
    assert got[5] == ("a@drops", "b@drops", "a@clean", "b@clean")
    assert got[4] is None and want[4] is None
    g_leaves = jax.tree_util.tree_leaves(interop.to_numpy_tree(
        (got[0].scenes_teach, got[0].scenes_repeat, got[0].routes)
        + tuple(got[1:4])))
    w_leaves = jax.tree_util.tree_leaves(
        (want[0].scenes_teach, want[0].scenes_repeat, want[0].routes)
        + tuple(want[1:4]))
    assert len(g_leaves) == len(w_leaves)
    for g, x in zip(g_leaves, w_leaves):
        assert np.array_equal(g, np.asarray(x))
    clean = got[0].scenes_repeat
    assert not (clean.valid[2:] & clean.drop_mask[2:]).any()


# -------------------------------------------------- repeat step parity ----

def slice_configs():
    """(JAX teach, port teach, {mode: (JAX config, port config)}) on the
    miniature scene, each preset keeping its own planner / control flags."""
    jt, tt, jr, tr = configs()
    small = small_config()
    geometry = {k: getattr(small.planner, k) for k in
                ("window", "path_len", "max_waypoints", "goal_timeout_ticks")}

    def cut(base, preset):
        return preset.replace(
            camera=base.camera, map=base.map, landmarks=base.landmarks,
            planner=dataclasses.replace(preset.planner, **geometry),
            fusion=dataclasses.replace(preset.fusion,
                                       align_window=ALIGN_WINDOW))

    modes = {"stock": (cut(jr, jbase.stock_nav2()),
                       cut(tr, tbase.stock_nav2())),
             "encoder": (cut(jr, jcfg.encoder_only()),
                         cut(tr, tcfg.encoder_only()))}
    for j, t in modes.values():
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return jt, tt, modes


def _stack2(a, b):
    return jax.tree_util.tree_map(lambda x, y: np.stack(
        [np.asarray(x), np.asarray(y)]), a, b)


@pytest.fixture(scope="module")
def step_runs():
    jt_cfg, tt_cfg, modes = slice_configs()
    packed, _, _ = pack_test_route(straight_route(), jt_cfg)
    teach = t_run_teach(batch1(tiny_scene(drop_on_path=False)),
                        batch1(packed), tt_cfg, TEACH_TICKS)
    trace_np = interop.to_numpy_tree(teach.trace)
    jdata = jcamp.CampaignData(None, None, jax.tree_util.tree_map(
        lambda x: np.asarray(x)[None], packed), ("straight",))
    jw, jn = jcamp.teach_waypoints(jdata, teach._replace(trace=trace_np),
                                   modes["stock"][0], source="vio")
    wps1, n1 = np.asarray(jw)[0], int(np.asarray(jn)[0])
    scenes = _stack2(tiny_scene(drop_on_path=True),
                     tiny_scene(drop_on_path=False))
    routes = _stack2(packed, packed)
    grid = np.repeat(teach.teach_grid.numpy(), 2, 0)
    stores = jax.tree_util.tree_map(lambda x: np.repeat(x, 2, 0),
                                    interop.to_numpy_tree(teach.store))
    out = {}
    for mode, n_ticks in (("stock", STOCK_TICKS), ("encoder", ENCODER_TICKS)):
        j_cfg, t_cfg = modes[mode]
        # the campaign's one-time projection, both packages on one input
        jw2, jn2 = jcamp.apply_stock_projection(
            grid, np.stack([wps1, wps1]), np.array([n1, n1]), j_cfg)
        tw2, tn2 = tcamp.apply_stock_projection(
            torch.from_numpy(grid), torch.from_numpy(np.stack([wps1, wps1])),
            torch.tensor([n1, n1], dtype=torch.int32), t_cfg)
        assert np.array_equal(tw2.numpy(), np.asarray(jw2))
        assert tn2.tolist() == np.asarray(jn2).tolist()
        jstep = jax.jit(jax.vmap(
            lambda c, t, sc, rt, g, st, cfg=j_cfg: j_repeat_step(
                c, t, sc, rt, g, st, cfg),
            in_axes=(0, None, 0, 0, 0, 0)))
        c = jax.vmap(lambda rt, w, nw: init_repeat_carry(rt, w, nw, j_cfg))(
            routes, jnp.asarray(jw2), jnp.asarray(jn2))
        c = jax.tree_util.tree_map(lambda x: jnp.asarray(x, x.dtype), c)
        traces = []
        for t in range(n_ticks):
            c, tr_t = jstep(c, jnp.int32(t), scenes, routes, grid, stores)
            traces.append(tr_t)
        jtrace = jax.tree_util.tree_map(lambda *x: np.stack(x, 1), *traces)
        trep = t_run_repeat(interop.from_numpy_tree(scenes, "cpu"),
                            interop.from_numpy_tree(routes, "cpu"),
                            torch.from_numpy(grid), tw2, tn2, t_cfg, n_ticks,
                            store=interop.from_numpy_tree(stores, "cpu"))
        out[mode] = (jtrace, jax.tree_util.tree_map(np.asarray, c), trep)
    return out


@pytest.mark.parametrize("mode", ["stock", "encoder"])
def test_repeat_matches_jax(step_runs, mode):
    jtrace, jfinal, trep = step_runs[mode]
    for f in STOCK_DISCRETE:
        got = getattr(trep.trace, f).numpy()
        want = np.asarray(getattr(jtrace, f))
        bad = np.flatnonzero((got != want).any(0))
        assert len(bad) == 0, f"{f} differs from tick {bad[:1]}"
    for f in ("gt_xy", "gt_yaw", "nav_xy", "vio_xy", "cmd_v"):
        np.testing.assert_allclose(getattr(trep.trace, f).numpy(),
                                   np.asarray(getattr(jtrace, f)),
                                   atol=POSE_ATOL, err_msg=f)
    ctrl = interop.to_numpy_tree(trep.final.ctrl)
    assert type(ctrl).__name__ == type(jfinal.ctrl).__name__
    for f in jfinal.ctrl._fields:
        g, w = getattr(ctrl, f), getattr(jfinal.ctrl, f)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=POSE_ATOL, err_msg=f)
        else:
            assert np.array_equal(g, w), f


def test_stock_repeat_runs_its_stack(step_runs):
    """No anchors, the RPP follower's phase in the trace, the VIO on, the
    relay committed and the robots driving after the bring-up hold."""
    jtrace, _, trep = step_runs["stock"]
    tr = trep.trace
    assert (tr.anchor_reason == -1).all() and not tr.anchor_ok.any()
    assert (tr.recovery_phase >= 0).all()
    assert (tr.vio_tracked[:, -1] >= 8).all()
    assert trep.final.fusion.committed.all()
    assert (tr.cmd_v[:, :ALIGN_WINDOW - 1] == 0).all()
    gt = tr.gt_xy.numpy()
    assert (np.hypot(*(gt[:, -1] - gt[:, 0]).T) > 1.0).all()


def test_encoder_repeat_runs_dead_reckoning(step_runs):
    """No VIO, no anchors, no bring-up hold: the relay dead-reckons on
    encoder and compass from the first tick."""
    from nclt_slam_tpu_torch.fusion.relay import REGIME_ENCODER

    _, _, trep = step_runs["encoder"]
    tr = trep.trace
    assert (tr.regime == REGIME_ENCODER).all()
    assert (tr.vio_xy == 0).all() and (tr.vio_ndesc == -1).all()
    assert (tr.recovery_phase == -1).all()
    assert (tr.cmd_v[:, 1:10] != 0).any()
    gt = tr.gt_xy.numpy()
    assert (np.hypot(*(gt[:, -1] - gt[:, 0]).T) > 1.0).all()


# ---------------------------------------------------- calibration tool ----

def test_calibrate_counts_match_jax_tool(monkeypatch):
    """``torch_calibrate.teach_drift`` and ``anchor_outcomes`` on the ours
    fixture's teach and repeat traces against ``tools/calibrate.run``'s own
    arithmetic (its repeat and metrics stubbed to hand it these traces;
    the fixture records no anchor shifts, so those are drawn from a seed,
    and the last 40 ticks of route 0 are marked done so that the live-
    attempt rule counts)."""
    import calibrate
    import torch_calibrate
    from nclt_slam_tpu.rollout import campaign

    fx = np.load(REPO / "tests" / "data" / "torch_ours_campaign_fixture.npz")
    names = tuple(str(n) for n in fx["routes"])
    rng = np.random.RandomState(5)
    done = fx["repeat_done"].copy()
    done[0, -40:] = True

    class Trace:
        pass

    teach = Trace()
    teach.trace = Trace()
    # a teach longer than the 200-tick settling window: the fixture's
    # 150 ticks, twice, the second lap shifted along the track
    teach.trace.gt_xy = np.concatenate(
        [fx["teach_gt_xy"], fx["teach_gt_xy"] + 3.0], 1)
    teach.trace.vio_xy = np.concatenate(
        [fx["teach_vio_xy"], fx["teach_vio_xy"] + 3.0], 1)
    teach.trace.done = np.concatenate([fx["teach_done"]] * 2, 1)
    teach.teach_grid = teach.store = None
    rep = Trace()
    rep.trace = Trace()
    rep.trace.anchor_reason = fx["repeat_anchor_reason"]
    rep.trace.anchor_ok = fx["repeat_anchor_ok"]
    rep.trace.anchor_inliers = fx["repeat_anchor_inliers"]
    rep.trace.anchor_shift = rng.uniform(0, 4, done.shape).astype(np.float32)
    rep.trace.done = done
    data = jcamp.CampaignData(None, None, None, names)
    monkeypatch.setattr(campaign, "run_campaign_repeat",
                        lambda *a, **k: rep)
    monkeypatch.setattr(campaign, "campaign_metrics",
                        lambda *a, **k: ({}, {}))
    (_, _, _, want_drift, want_anchor), _ = calibrate.run(
        names, "ours", 0, 0, "cpu", shared=(data, teach, None, None))
    got_drift = torch_calibrate.teach_drift(names, teach.trace)
    got_anchor = torch_calibrate.anchor_outcomes(names, rep.trace)
    assert set(got_drift) == set(want_drift) == set(names)
    for name in names:
        np.testing.assert_allclose(got_drift[name], want_drift[name],
                                   rtol=1e-12)
    assert got_anchor == want_anchor
    assert got_anchor[names[0]]["attempts"] < \
        int((fx["repeat_anchor_reason"][0] >= 0).sum())


def test_calibrate_refuses_one_file_for_every_mode():
    import torch_calibrate

    with pytest.raises(SystemExit):
        torch_calibrate.json_path("out.json", "ours", torch_calibrate.MODES)
    assert str(torch_calibrate.json_path(
        "out_MODE.json", "stock", torch_calibrate.MODES)) == "out_stock.json"
    assert str(torch_calibrate.json_path("o.json", "ours", ["ours"])) == \
        "o.json"
