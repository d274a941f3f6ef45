"""The port's config mirror equals the JAX package's presets field for
field."""

import dataclasses

import pytest

from nclt_slam_tpu import config as jcfg
from nclt_slam_tpu.baselines import configs as jbase
from nclt_slam_tpu_torch import config as tcfg
from nclt_slam_tpu_torch.baselines import configs as tbase

PRESETS = ("ours", "gt_localization", "encoder_only", "rgbd_no_imu")


@pytest.mark.parametrize("name", PRESETS)
def test_preset_matches_jax(name):
    assert dataclasses.asdict(getattr(tcfg, name)()) == \
        dataclasses.asdict(getattr(jcfg, name)())


def test_baseline_rgbd_no_imu_matches_jax():
    got, want = tbase.rgbd_no_imu(), jbase.rgbd_no_imu()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.planner.gt_stall_abort and not got.mode.use_imu
    assert got.mode.use_slam and got.mode.use_anchors


def test_baseline_stock_nav2_matches_jax():
    got, want = tbase.stock_nav2(), jbase.stock_nav2()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.control.use_rpp and got.planner.stock_follow
    assert got.mode.use_slam and not got.mode.use_anchors
    assert got.planner.gt_stall_abort and not got.control.enable_prox


def test_baseline_rgbd_ba_matches_the_calibration_mode():
    """``rgbd_ba`` is the config ``tools/calibrate.py`` builds inline: the
    JAX baselines' ``rgbd_no_imu()`` with ``vio.enable_local_ba``."""
    base = jbase.rgbd_no_imu()
    want = base.replace(vio=dataclasses.replace(base.vio,
                                                enable_local_ba=True))
    got = tbase.rgbd_ba()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.vio.enable_local_ba and not tbase.rgbd_no_imu().vio.enable_local_ba


def test_default_and_derived_sizes_match_jax():
    assert dataclasses.asdict(tcfg.DEFAULT) == dataclasses.asdict(jcfg.DEFAULT)
    assert (tcfg.DEFAULT.map.rows, tcfg.DEFAULT.map.cols) == \
        (jcfg.DEFAULT.map.rows, jcfg.DEFAULT.map.cols)
    # every sub-config class is mirrored under the same name
    for f in dataclasses.fields(jcfg.Config):
        assert f.name in {g.name for g in dataclasses.fields(tcfg.Config)}
