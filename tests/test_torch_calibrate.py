"""The port's calibration front end in pieces: ``tools/torch_calibrate.py``'s
split path.  The teach written to its checkpoint (``teach_phase``), then
``main`` run once per repeat chunk (``--budget-s 0`` pauses after every
chunk into ``--repeat-ckpt``, the next run loads the teach and continues
the repeat): the table it writes (the JAX tool's keys and the executed
ticks) equals the one-call ``run``'s off the same teach, exactly, for ours
and for stock (whose waypoint projection runs again at every chunk).  Two
routes at full width on the CPU; the teach passes the teach drift's
200-tick settling window.  The seed axis is in
``test_torch_calibrate_seeds.py``, the parity check in
``test_torch_calibrate_parity.py``.
"""

import json

import pytest
import torch

from torch_calibrate_common import (  # noqa: F401 (taught: a fixture)
    CHUNK,
    JAX_KEYS,
    REPEAT_TICKS,
    ROUTES,
    TEACH_TICKS,
    one_call,
    taught,
)
import torch_calibrate  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("mode", ["ours", "stock"])
def test_split_path_writes_the_one_call_table(taught, mode, tmp_path,
                                              monkeypatch):
    shared, meta, ckpt = taught
    (names, per_route, agg, drift, anchor), _, rep = one_call(shared, mode)
    one = json.loads(json.dumps(torch_calibrate.table(
        names, per_route, agg, drift, anchor, mode), default=float))

    # the split runs rebuild the campaign from the seed; hand them the
    # module's build (the same data) to save its seconds
    monkeypatch.setattr(torch_calibrate, "build",
                        lambda names, device: shared[0])
    argv = ["--routes", ",".join(ROUTES), "--mode", mode,
            "--ticks", str(REPEAT_TICKS), "--teach-ticks", str(TEACH_TICKS),
            "--chunk", str(CHUNK), "--device", "cpu",
            "--teach-ckpt", str(ckpt),
            "--repeat-ckpt", str(tmp_path / "MODE.ckpt"), "--budget-s", "0",
            "--json", str(tmp_path / "MODE.json")]
    assert torch_calibrate.main(argv) == torch_calibrate.PAUSED
    assert (tmp_path / f"{mode}.ckpt").is_file()
    assert not (tmp_path / f"{mode}.json").exists()
    assert torch_calibrate.main(argv) == 0
    assert not (tmp_path / f"{mode}.ckpt").exists()
    got = json.loads((tmp_path / f"{mode}.json").read_text())
    for key in JAX_KEYS:
        assert got[key] == one[key], key
    assert got["ticks_executed"] == {"teach": TEACH_TICKS,
                                     "repeat": REPEAT_TICKS}
    assert got["repeat_calls"] == 2
    assert got["card"] == {"teach": None, "repeat": [None]}
    assert set(got["wall_s"]) == {"build", "teach", "repeat", "metrics"}
    assert got["wall_s"]["teach"] == meta["teach_s"]


def test_teach_checkpoint_refuses_another_teach(taught):
    _, _, ckpt = taught
    with pytest.raises(SystemExit, match="holds a teach"):
        torch_calibrate.teach_phase(list(ROUTES), TEACH_TICKS + 1, "cpu",
                                    ckpt, CHUNK, None)
