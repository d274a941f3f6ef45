"""The repeat's seed axis of ``tools/torch_calibrate.py`` (``--seeds``):
the stock repeat at the two routes x seeds (1, 2) as one batch of four
rows for 20 ticks; seed 1's rows bit-equal beside seed 2 or seed 3, each
block against the untiled run started from ``init_repeat_carry(seed=s)``
(discrete sequences equal, floats within the CPU's vector-tail rounding);
the port's seed-2 carry (key, IMU state) equal to JAX's; seed 2's rows
against JAX's ``run_campaign_repeat`` from JAX's seed-2 carry within the
fixture replays' tolerances (``chip_smoke.FIX_*``); the tool's per-seed
tables and stop tick; ``tools/torch_batch_probe.py`` on the CPU.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nclt_slam_tpu.baselines import configs as jbase
from nclt_slam_tpu.rollout import campaign as jcamp
from nclt_slam_tpu.rollout.repeat import init_repeat_carry as j_init_carry
from nclt_slam_tpu_torch import interop
from nclt_slam_tpu_torch.rollout import campaign as tcamp
from nclt_slam_tpu_torch.rollout.repeat import RepeatResult, init_repeat_carry

from torch_calibrate_common import (  # noqa: F401 (taught: a fixture)
    CHUNK,
    CPU_BATCH_ATOL,
    REPEAT_TICKS,
    ROUTES,
    SEEDS,
    one_call,
    taught,
)
import chip_smoke  # noqa: E402
import torch_batch_probe  # noqa: E402
import torch_calibrate  # noqa: E402

torch.set_num_threads(1)


def untiled(shared, mode, seed):
    """The mode's untiled two-route repeat started from
    ``init_repeat_carry(seed=seed)`` (at seed 1 the tool's one-call run)."""
    if seed == 1:
        return one_call(shared, mode)[2]
    data, teach, wps, n_wps = shared
    cfg = torch_calibrate.mode_config(mode)
    run_wps, run_n = tcamp.apply_stock_projection(teach.teach_grid, wps,
                                                  n_wps, cfg)
    return tcamp.run_campaign_repeat(
        data, teach.teach_grid, wps, n_wps, cfg, REPEAT_TICKS,
        stores=teach.store, chunk=CHUNK,
        carry=init_repeat_carry(data.routes, run_wps, run_n, cfg,
                                seed=seed))


@pytest.fixture(scope="module")
def seed_runs(taught):
    """The stock repeat tiled at seeds (1, 2) and at (1, 3), and the untiled
    runs at seeds 1 and 2."""
    shared = taught[0]
    tiled = {seeds: torch_calibrate.repeat_phase(
        shared, "stock", REPEAT_TICKS, CHUNK, None, None, 0.0, None,
        seeds=seeds) for seeds in (SEEDS, (1, 3))}
    return tiled, {s: untiled(shared, "stock", s) for s in SEEDS}


def rows(trace, i):
    R = len(ROUTES)
    return type(trace)(*(np.asarray(x)[i * R:(i + 1) * R] for x in trace))


def test_seed_block_depends_on_its_seed_alone(seed_runs):
    """Seed 1's rows bit-equal whichever seed fills the other block (one
    batch shape), seed 2's rows not seed 1's."""
    tiled, _ = seed_runs
    (a, meta), (b, _) = tiled[SEEDS], tiled[(1, 3)]
    assert meta["seeds"] == list(SEEDS)
    assert a.trace.done.shape == (len(ROUTES) * 2, REPEAT_TICKS)
    for f in a.trace._fields:
        assert chip_smoke.same_bits(getattr(rows(a.trace, 0), f),
                                    getattr(rows(b.trace, 0), f)), f
    assert not chip_smoke.same_bits(rows(a.trace, 0).vio_xy,
                                    rows(a.trace, 1).vio_xy)


def test_seed_blocks_are_the_untiled_runs(seed_runs):
    """Each block against the untiled run from ``init_repeat_carry(seed=s)``:
    every discrete sequence equal, every float within ``CPU_BATCH_ATOL``.
    Not bit for bit on the CPU: ATen's vectorized ``atan2`` rounds the
    scalar tail of a tensor another way than its vector body (4.7e-10 at
    tick 0 in ``terrain_pitch_roll``), and a tensor of more rows puts
    other elements in the tail; on the card every element takes one path,
    and ``chip_smoke.py`` 11i holds the blocks bit-equal to the untiled
    run."""
    tiled, one = seed_runs
    trace = tiled[SEEDS][0].trace
    for i, s in enumerate(SEEDS):
        got, want = rows(trace, i), one[s].trace
        for f in got._fields:
            g, w = getattr(got, f), getattr(want, f)
            if g.dtype.kind == "f":
                np.testing.assert_allclose(g, w, rtol=0,
                                           atol=CPU_BATCH_ATOL,
                                           err_msg=f"seed {s} {f}")
            else:
                assert np.array_equal(g, w), (s, f)


def test_seed_tables_split_the_batch(taught, seed_runs):
    """``seed_tables``: each seed's table is the table of its own rows, with
    their route events, over its own stop tick; seed 1's table is the same
    beside seed 2 or 3."""
    shared = taught[0]
    tiled, _ = seed_runs
    drift = torch_calibrate.teach_drift(shared[0].names, shared[1].trace)
    tables = {seeds: torch_calibrate.seed_tables(
        shared, tiled[seeds][0], "stock", seeds, REPEAT_TICKS, CHUNK, drift)
        for seeds in tiled}
    assert list(tables[SEEDS]) == list(SEEDS)
    dump = lambda t: json.dumps(t, default=float)  # noqa: E731
    assert dump(tables[SEEDS][1]) == dump(tables[(1, 3)][1])
    for i, s in enumerate(SEEDS):
        trace = rows(tiled[SEEDS][0].trace, i)
        per_route, agg = tcamp.campaign_metrics(
            shared[0], RepeatResult(trace=trace, final=None), shared[2],
            shared[3], torch_calibrate.mode_config("stock"))
        want = dict(torch_calibrate.table(
            shared[0].names, per_route, agg, drift,
            torch_calibrate.anchor_outcomes(shared[0].names, trace), "stock"),
            events=torch_calibrate.route_events(
                shared[0].names, trace,
                torch_calibrate.mode_config("stock").vio))
        assert dump(tables[SEEDS][s]) == dump((want, REPEAT_TICKS))


def test_batch_probe_finds_the_cpus_vector_tails(taught):
    """``tools/torch_batch_probe.py`` on the CPU: the one call that gives
    the first rows otherwise at twice the rows, in the first stock tick,
    is ATen's vectorized ``atan2``."""
    calls = torch_batch_probe.batch_dependent_calls(taught[0], "stock",
                                                    SEEDS, 0, 1)
    assert calls and {c["call"] for c in calls} == {"atan2"}
    assert all(c["site"].startswith("nclt_slam_tpu_torch/") for c in calls)


def test_batch_probe_first_differences(seed_runs):
    """Seed 1's rows against themselves: no difference; against seed 2's
    rows: the first tick of each field that differs."""
    tiled, one = seed_runs
    R = len(ROUTES)
    assert torch_batch_probe.first_differences(one[1].trace,
                                               one[1].trace, R) == {}
    got = torch_batch_probe.first_differences(
        rows(tiled[SEEDS][0].trace, 1), one[1].trace, R)
    assert "vio_xy" in got and all(0 <= t < REPEAT_TICKS
                                   for t in got.values())


@pytest.mark.parametrize("done_at,want", [
    ((3, 7), 9), ((3, 14), 18), ((3, None), 25), ((8, 8), 9), ((9, 9), 18),
    ((24, 0), 25)])
def test_seed_stop_is_the_untiled_runs_first_all_done_boundary(done_at,
                                                               want):
    """25 ticks in chunks of 10 run as 3 chunks of 9: an untiled run stops
    at the first boundary (9, 18) at which every row is done, else runs
    all 25 (two rows, done from the ticks ``done_at``)."""
    assert tcamp.planned_chunks(25, 10) == (3, 9)
    done = np.zeros((2, 25), bool)
    for r, t in enumerate(done_at):
        if t is not None:
            done[r, t:] = True
    assert torch_calibrate.seed_stop(done, 25, 10) == want


def test_seed_two_carry_is_jaxs(taught):
    shared = taught[0]
    data, teach, wps, n_wps = shared
    carry = torch_calibrate.seed_batch(shared, "stock", SEEDS)[-1]
    got = interop.to_numpy_tree(carry)
    R = len(ROUTES)
    jw, jn = jcamp.apply_stock_projection(teach.teach_grid.numpy(),
                                          wps.numpy(), n_wps.numpy(),
                                          jbase.stock_nav2())
    routes = interop.to_numpy_tree(data.routes)
    for i, s in enumerate(SEEDS):
        want = jax.vmap(lambda rt, w, n, s=s: j_init_carry(
            rt, w, n, jbase.stock_nav2(), seed=s))(routes, jw, jn)
        assert np.array_equal(got.key[i * R:(i + 1) * R],
                              np.asarray(want.key))
        for a, b in zip(jax.tree_util.tree_leaves(got.imu),
                        jax.tree_util.tree_leaves(want.imu)):
            assert np.array_equal(a[i * R:(i + 1) * R], np.asarray(b))
    assert not np.array_equal(got.key[:R], got.key[R:])


def test_seed_two_rows_track_jax(taught, seed_runs):
    """Seed 2's rows of the batch against JAX's ``run_campaign_repeat``
    from JAX's seed-2 carry on the same teach, map, waypoints and stores:
    the fixture replays' tolerances (every discrete sequence equal, GT
    within FIX_REPEAT_ATOL_M, nav and VIO within FIX_NAV_ATOL_M)."""
    shared = taught[0]
    data, teach, wps, n_wps = shared
    tiled = seed_runs[0][SEEDS][0]
    R = len(ROUTES)
    j_cfg = jbase.stock_nav2()
    grid = jnp.asarray(teach.teach_grid.numpy())
    jw, jn = jcamp.apply_stock_projection(grid, jnp.asarray(wps.numpy()),
                                          jnp.asarray(n_wps.numpy()), j_cfg)
    routes = interop.to_numpy_tree(data.routes)
    carry = jax.vmap(lambda rt, w, n: j_init_carry(rt, w, n, j_cfg,
                                                   seed=2))(routes, jw, jn)
    jdata = jcamp.CampaignData(None, interop.to_numpy_tree(
        data.scenes_repeat), routes, data.names)
    rep = jcamp.run_campaign_repeat(
        jdata, grid, jw, jn, j_cfg, REPEAT_TICKS,
        stores=interop.to_numpy_tree(teach.store), chunk=CHUNK, carry=carry)
    got = jax.tree_util.tree_map(lambda x: np.asarray(x)[R:], tiled.trace)
    for f in chip_smoke.OURS_DISCRETE + chip_smoke.STOCK_DISCRETE:
        assert np.array_equal(getattr(got, f), np.asarray(
            getattr(rep.trace, f))), f
    for f, atol in (("gt_xy", chip_smoke.FIX_REPEAT_ATOL_M),
                    ("nav_xy", chip_smoke.FIX_NAV_ATOL_M),
                    ("vio_xy", chip_smoke.FIX_NAV_ATOL_M)):
        np.testing.assert_allclose(getattr(got, f),
                                   np.asarray(getattr(rep.trace, f)),
                                   atol=atol, rtol=0, err_msg=f)


def test_seed_checkpoint_refuses_other_seeds(taught, tmp_path):
    """A repeat paused at seeds (1, 2) (after its first 2-tick chunk) is
    not continued at seeds (1, 3)."""
    shared = taught[0]
    ckpt = tmp_path / "stock.ckpt"
    assert torch_calibrate.repeat_phase(
        shared, "stock", 4, 2, ckpt, 0.0, 0.0, None, seeds=SEEDS) is None
    with pytest.raises(SystemExit, match="holds a repeat"):
        torch_calibrate.repeat_phase(shared, "stock", 4, 2, ckpt, 0.0, 0.0,
                                     None, seeds=(1, 3))


@pytest.mark.parametrize("text,want", [
    ("1", (1,)), ("1-8", tuple(range(1, 9))), ("1,3,5", (1, 3, 5)),
    ("1-3,7", (1, 2, 3, 7))])
def test_parse_seeds(text, want):
    assert torch_calibrate.parse_seeds(text) == want


@pytest.mark.parametrize("text", ["", "1,1", "3-1", "a"])
def test_parse_seeds_refuses(text):
    with pytest.raises(Exception):
        torch_calibrate.parse_seeds(text)
