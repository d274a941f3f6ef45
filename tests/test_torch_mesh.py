"""The route batch split over devices (``parallel/mesh.py``) and the
campaign runners' early stop, against the JAX package.

- A campaign whose ``names`` is shorter than its batch (the mesh's view
  passes none) runs as many chunks in the port as in JAX: both stop only
  once every row of the batch is done.
- ``pad_batch`` replicates the last route as JAX's does.
- The GT repeat of two real routes at ``--scale 0.25``, 40 ticks, sharded
  over JAX's 8-device virtual CPU mesh and over 8 CPU devices of the port:
  the padded batch of 8, the GT traces within the slice's 1e-3 m
  (``tests/test_torch_slice.py``: the packages' float32 rounding differs
  by ~1e-6 m a tick), every discrete outcome equal, each pad route equal
  to the last real route.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nclt_slam_tpu.cli.common import config_for as j_config_for
from nclt_slam_tpu.parallel import mesh as jmesh
from nclt_slam_tpu.rollout import campaign as jcamp
from nclt_slam_tpu_torch import interop
from nclt_slam_tpu_torch.cli.common import config_for as t_config_for
from nclt_slam_tpu_torch.parallel import mesh as tmesh
from nclt_slam_tpu_torch.rollout import campaign as tcamp

torch.set_num_threads(1)

ROUTES = ["01_road", "08_nw_sw"]
TICKS = 40     # the JAX mesh runs ~0.3 s a tick here: the file stays ~1 min
POSE_ATOL = 1e-3
DISCRETE = ("wp_idx", "done", "fired", "regime", "plan_fails",
            "goal_blocked")


@pytest.fixture(scope="module")
def campaign():
    """Both packages' GT campaign inputs: JAX's scenes and routes carried
    into the port, the routes' own 4 m waypoints, an all-free teach map."""
    jcfg, tcfg = j_config_for("gt", 0.25), t_config_for("gt", 0.25)
    jd = jcamp.build_campaign(ROUTES, cfg=jcfg)
    td = interop.from_numpy_tree(jd, "cpu")
    grids = np.zeros((len(ROUTES), jcfg.map.rows, jcfg.map.cols), np.int8)
    return jcfg, tcfg, jd, td, grids


def test_early_stop_counts_the_batch_not_the_names(campaign):
    """No route finishes in 15 ticks, so both packages run all three
    chunks of 5, although ``names`` is empty, as in JAX's mesh view; the
    port used to stop after the first chunk, when the count of done
    routes (0) equalled the count of names."""
    jcfg, tcfg, jd, td, grids = campaign
    jview = jcamp.CampaignData(jd.scenes_teach, jd.scenes_repeat, jd.routes,
                               names=[])
    tview = tcamp.CampaignData(td.scenes_teach, td.scenes_repeat, td.routes,
                               names=())
    jcalls, tcalls = [], []
    jr = jcamp.run_campaign_repeat(jview, jnp.asarray(grids), jd.routes.wps,
                                   jd.routes.n_wps, jcfg, 15, chunk=5,
                                   progress=lambda *a: jcalls.append(a))
    tr = tcamp.run_campaign_repeat(tview, torch.from_numpy(grids),
                                   td.routes.wps, td.routes.n_wps, tcfg, 15,
                                   chunk=5,
                                   progress=lambda *a: tcalls.append(a))
    assert not np.asarray(jr.trace.done).any()
    assert len(jcalls) == 3
    assert tcalls == jcalls
    assert tr.trace.gt_xy.shape == np.asarray(jr.trace.gt_xy).shape


def test_pad_batch_matches_jax():
    rng = np.random.RandomState(0)
    a = rng.randn(5, 3, 2).astype(np.float32)
    b = rng.randint(0, 9, 5).astype(np.int32)
    for multiple in (1, 4, 5, 8):
        ja, jb = jmesh.pad_batch((jnp.asarray(a), jnp.asarray(b)), multiple)
        ta, tb = tmesh.pad_batch((torch.from_numpy(a), torch.from_numpy(b)),
                                 multiple)
        assert np.array_equal(ta.numpy(), np.asarray(ja))
        assert np.array_equal(tb.numpy(), np.asarray(jb))


def test_shards_are_contiguous_and_on_their_devices():
    x = torch.arange(8 * 3).reshape(8, 3)
    mesh = [torch.device("cpu")] * 4
    shards = tmesh.shard_over_routes((x, (x[:, 0],)), mesh)
    assert len(shards) == 4
    for i, (xs, (x0,)) in enumerate(shards):
        assert torch.equal(xs, x[2 * i:2 * i + 2])
        assert torch.equal(x0, x[2 * i:2 * i + 2, 0])
    with pytest.raises(ValueError, match="pad_batch"):
        tmesh.shard_over_routes(x[:7], mesh)


def test_route_mesh_needs_a_card_or_a_device_list():
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in tmesh.route_mesh())
    else:
        with pytest.raises(RuntimeError, match="mesh="):
            tmesh.route_mesh()


def test_sharded_gt_repeat_matches_jax_mesh(campaign):
    jcfg, tcfg, jd, td, grids = campaign
    assert len(jax.devices()) == 8
    jr = jmesh.sharded_campaign_repeat(jd, jnp.asarray(grids), jd.routes.wps,
                                       jd.routes.n_wps, jcfg, TICKS,
                                       mesh=jmesh.route_mesh(8))
    tr = tmesh.sharded_campaign_repeat(td, torch.from_numpy(grids),
                                       td.routes.wps, td.routes.n_wps, tcfg,
                                       TICKS, mesh=[torch.device("cpu")] * 8)
    jgt = np.asarray(jr.trace.gt_xy)
    assert jgt.shape[:2] == tr.trace.gt_xy.shape[:2] == (8, TICKS)
    assert tr.final.robot.xy.shape == (8, 2)
    moved = np.hypot(*(tr.trace.gt_xy[:2, -1] - tr.trace.gt_xy[:2, 0]).T)
    assert (moved > 1.0).all(), moved
    np.testing.assert_allclose(tr.trace.gt_xy, jgt, atol=POSE_ATOL)
    np.testing.assert_allclose(tr.trace.gt_yaw, np.asarray(jr.trace.gt_yaw),
                               atol=POSE_ATOL)
    for name in DISCRETE:
        assert np.array_equal(getattr(tr.trace, name),
                              np.asarray(getattr(jr.trace, name))), name
    for pad in range(2, 8):
        for name in tr.trace._fields:
            assert np.array_equal(getattr(tr.trace, name)[pad],
                                  getattr(tr.trace, name)[1]), (pad, name)
