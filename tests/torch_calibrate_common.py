"""Shared settings and fixtures of the calibration front end's tests
(``tests/test_torch_calibrate*.py``): the two-route CPU teach written
through ``tools/torch_calibrate.py``'s own path, and the tool's one-call
repeat off it."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
sys.path.insert(0, str(REPO))
import torch_calibrate  # noqa: E402
import torch_campaign_parity as parity  # noqa: E402

ROUTES = ("08_nw_sw", "01_road")
TEACH_TICKS = 210
REPEAT_TICKS = 20
CHUNK = 10
JAX_DIR = REPO / "artifacts" / "calibration"
CARD_DIR = REPO / "artifacts" / "calibration_torch"
JAX_KEYS = ("mode", "per_route", "agg", "teach_drift", "anchor")
SEEDS = (1, 2)
SEED_DIR = CARD_DIR / parity.SEED_DIR
CPU_BATCH_ATOL = 1e-5   # seed blocks against untiled runs, CPU only


@pytest.fixture(scope="module")
def taught(tmp_path_factory):
    """One teach through the tool's own path, written to its checkpoint
    (built once in each test module that asks for it)."""
    ckpt = tmp_path_factory.mktemp("calibrate") / "teach.ckpt"
    shared, meta = torch_calibrate.teach_phase(
        list(ROUTES), TEACH_TICKS, "cpu", ckpt, CHUNK, None)
    assert ckpt.is_file()
    return shared, meta, ckpt


# (id of the teach, mode) -> (the teach, the run): the teach is kept so
# that its id is not reused
ONE_CALL = {}


def one_call(shared, mode):
    """``torch_calibrate.run``'s repeat of ``mode`` off the teach
    ``shared`` (run once a teach)."""
    key = (id(shared), mode)
    if key not in ONE_CALL:
        ONE_CALL[key] = shared, torch_calibrate.run(
            None, mode, TEACH_TICKS, REPEAT_TICKS, "cpu", shared=shared,
            chunk=CHUNK)
    return ONE_CALL[key][1]
