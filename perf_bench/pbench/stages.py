"""Single stages of the program held to the plain references in
``plainref``, on the program's own inputs at the window's sizes.

``StageRecorder`` wraps four of the port's entry points over the first
ticks of the window (``ticks``, by the tick ``repeat_step`` is given), and
keeps the inputs and outputs of each one's latest call there, copied:
the wheel
dynamics of a tick (``rollout/repeat.py:nav_substeps``), the IMU block
(``imu_block``), kernel K1 at each call site (``sensors/features.py:
cross_check``) and kernel K2 at each grid shape
(``planning/wavefront.py:wavefront_relax``).  ``stage_numbers`` then
compares each recorded output with the plain reference's on the recorded
inputs.  A stage that a configuration runs and that was not recorded
reads infinity.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from plainref import dynamics, hamming, imu, wavefront

PORT = "nclt_slam_tpu_torch"
STAGES = ("substeps", "imu", "k1", "k2")
NUMBERS = {"substeps": "substep_gap", "imu": "imu_gap", "k1": "k1_mismatch",
           "k2": "k2_gap"}


def _copy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, tuple):
        items = [_copy(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


class StageRecorder:
    """While installed, keeps ``calls[key] = (args, kwargs, output)`` of
    the latest call of each stage in a tick of ``ticks``, copied; in other
    ticks the wrappers only pass the call on."""

    def __init__(self, ticks):
        self.ticks, self.tick = ticks, None
        self.calls = {}
        self._undo = []

    def _wrap(self, module, name, key_of):
        fn = getattr(module, name)

        def recorded(*args, **kw):
            if self.tick not in self.ticks:
                return fn(*args, **kw)
            inputs = (_copy(args), _copy(kw))
            out = fn(*args, **kw)
            self.calls[key_of(args, kw)] = (*inputs, _copy(out))
            return out

        setattr(module, name, recorded)
        self._undo.append((module, name, fn))

    def __enter__(self):
        imp = importlib.import_module
        rep = imp(f"{PORT}.rollout.repeat")
        feat = imp(f"{PORT}.sensors.features")
        plan = imp(f"{PORT}.planning.wavefront")
        step = rep.repeat_step

        def stepped(carry, tick, *args, **kw):
            self.tick = tick
            try:
                return step(carry, tick, *args, **kw)
            finally:
                self.tick = None

        rep.repeat_step = stepped
        self._undo.append((rep, "repeat_step", step))
        self._wrap(rep, "nav_substeps", lambda a, kw: "substeps")
        self._wrap(rep, "imu_block", lambda a, kw: "imu")
        self._wrap(feat, "cross_check",
                   lambda a, kw: f"k1.{kw.get('site', 'other')}")
        self._wrap(plan, "wavefront_relax",
                   lambda a, kw: "k2.{}x{}".format(*a[0].shape[1:]))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self._undo):
            setattr(mod, name, fn)
        self._undo = []
        return False


def _np(t):
    return t.detach().cpu().numpy()


def _wrapped(a):
    return np.abs(np.arctan2(np.sin(a), np.cos(a)))


def substep_gap(call, sim) -> float:
    """Largest gap of position (m), heading (rad) and speeds over the
    tick's substeps."""
    (state, cmd_v, cmd_w, obs_xy, obs_r, obs_valid, key, _), _, out = call
    new, (pos, _) = out
    ref = dynamics.nav_substeps(
        _np(state.xy), _np(state.yaw), _np(state.v), _np(state.w),
        _np(cmd_v), _np(cmd_w), _np(obs_xy), _np(obs_r), _np(obs_valid),
        _np(key), sim)
    gaps = [np.abs(_np(new.xy) - ref["xy"]).max(),
            np.abs(_np(pos)[..., :2] - ref["path_xy"]).max(),
            _wrapped(_np(new.yaw) - ref["yaw"]).max(),
            np.abs(_np(new.v) - ref["v"]).max(),
            np.abs(_np(new.w) - ref["w"]).max()]
    return float(np.nan_to_num(max(gaps), nan=np.inf))


def imu_gap(call, cfg) -> float:
    """Largest gap of the measurements and of the new state's float
    fields; a differing count or flag reads infinity."""
    (state, positions, quats, dt, key, _), _, out = call
    new, meas = out
    ref = imu.imu_block({f: _np(getattr(state, f)) for f in state._fields},
                        _np(positions), _np(quats), float(dt), _np(key), cfg)
    gaps = [np.abs(_np(meas) - ref["meas"]).max()]
    for f in new._fields:
        a = _np(getattr(new, f))
        if a.dtype.kind == "f":
            gaps.append(np.abs(a - ref[f]).max())
        elif (a != ref[f]).any():
            return float("inf")
    return float(np.nan_to_num(max(gaps), nan=np.inf))


def k1_mismatch(call) -> int:
    """Differing elements of (best b, matched, best distance)."""
    (desc_a, valid_a, desc_b, valid_b), kw, out = call
    ref = hamming.cross_check(desc_a, valid_a, desc_b, valid_b,
                              kw["max_dist"])
    return sum(int((a.long() != b.long()).sum()) for a, b in zip(out, ref))


def k2_gap(call) -> float:
    """Largest gap of the relaxed potential over the cells the reference
    reaches, over the largest such potential (at least 1); a cell reached
    on one side only reads infinity."""
    (tc, phi0, n_iter), _, out = call
    ref = wavefront.relax(tc, phi0, int(n_iter))
    reached = ref < wavefront.OUTSIDE / 2
    if not torch.equal(reached, out < wavefront.OUTSIDE / 2):
        return float("inf")
    if not reached.any():
        return 0.0
    d = (out.double() - ref.double()).abs()[reached].max()
    scale = max(1.0, float(ref[reached].abs().max()))
    return float(torch.nan_to_num(d, nan=float("inf"))) / scale


def stage_numbers(calls: dict, stages, ref_cfg) -> dict:
    """The number of each stage in ``stages`` (names of ``STAGES``)."""
    nums = {}
    for st in stages:
        keys = [k for k in calls if k.split(".")[0] == st]
        if not keys:
            nums[NUMBERS[st]] = float("inf")
        elif st == "substeps":
            nums[NUMBERS[st]] = substep_gap(calls[keys[0]], ref_cfg.sim)
        elif st == "imu":
            nums[NUMBERS[st]] = imu_gap(calls[keys[0]], ref_cfg.imu)
        elif st == "k1":
            nums[NUMBERS[st]] = sum(k1_mismatch(calls[k]) for k in keys)
        else:
            nums[NUMBERS[st]] = max(k2_gap(calls[k]) for k in keys)
    return nums
