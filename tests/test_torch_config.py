"""The port's config mirror equals the JAX package's presets field for
field."""

import dataclasses

import pytest

from nclt_slam_tpu import config as jcfg
from nclt_slam_tpu_torch import config as tcfg

PRESETS = ("ours", "gt_localization", "encoder_only", "rgbd_no_imu")


@pytest.mark.parametrize("name", PRESETS)
def test_preset_matches_jax(name):
    assert dataclasses.asdict(getattr(tcfg, name)()) == \
        dataclasses.asdict(getattr(jcfg, name)())


def test_default_and_derived_sizes_match_jax():
    assert dataclasses.asdict(tcfg.DEFAULT) == dataclasses.asdict(jcfg.DEFAULT)
    assert (tcfg.DEFAULT.map.rows, tcfg.DEFAULT.map.cols) == \
        (jcfg.DEFAULT.map.rows, jcfg.DEFAULT.map.cols)
    # every sub-config class is mirrored under the same name
    for f in dataclasses.fields(jcfg.Config):
        assert f.name in {g.name for g in dataclasses.fields(tcfg.Config)}
