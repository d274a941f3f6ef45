"""Tracing / profiling utilities (``nclt_slam_tpu/utils/profiling.py``).

A steps/sec rate counter for rollout loops, a ``torch.profiler`` context
that writes a Chrome trace of the host and the card, and structured
rollout statistics extracted from traces (the single trace per rollout in
place of the reference's per-process log files).
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import numpy as np
import torch


class RateCounter:
    """Steps/sec counter with periodic throttled reporting."""

    def __init__(self, name: str = "steps", report_every: float = 5.0):
        self.name = name
        self.report_every = report_every
        self.t0 = time.perf_counter()
        self.last_report = self.t0
        self.count = 0

    def add(self, n: int = 1, log=print):
        self.count += n
        now = time.perf_counter()
        if now - self.last_report >= self.report_every:
            rate = self.count / (now - self.t0)
            log(f"[{self.name}] {self.count} total, {rate:.1f}/s")
            self.last_report = now

    @property
    def rate(self) -> float:
        return self.count / max(time.perf_counter() - self.t0, 1e-9)


@contextlib.contextmanager
def profile_trace(logdir):
    """Profile the block with ``torch.profiler`` (the host's ops, and the
    card's kernels when CUDA is present) and write its Chrome trace to
    ``logdir/trace.json`` (view with chrome://tracing or Perfetto).
    Yields the profiler, whose ``key_averages()`` is read after the
    block."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    path = Path(logdir) / "trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def rollout_stats(trace) -> dict:
    """Structured statistics from a RepeatTrace — the machine-readable
    replacement for grepping tf_slam.log / pp_follower.log / goals.log."""
    gt = _np(trace.gt_xy)
    nav = _np(trace.nav_xy)
    regime = _np(trace.regime)
    stats = {
        "ticks": int(gt.shape[-2]),
        "path_m": float(np.hypot(*np.diff(gt, axis=-2).T).sum()),
        "drift_mean_m": float(np.hypot(*(nav - gt).T).mean()),
        "drift_max_m": float(np.hypot(*(nav - gt).T).max()),
        "anchors_published": int(_np(trace.anchor_ok).sum()),
        "fired": bool(_np(trace.fired).any()),
        "done": bool(_np(trace.done).any()),
    }
    live = regime[regime >= 0]
    if live.size:
        counts = np.bincount(live, minlength=4)
        stats["regime_counts"] = {
            "no_anchor": int(counts[0]), "ok": int(counts[1]),
            "strong": int(counts[2]), "encoder": int(counts[3]),
        }
    if hasattr(trace, "vio_tracked"):
        tr = _np(trace.vio_tracked)
        tr = tr[tr >= 0]
        if tr.size:
            stats["vio_tracked_mean"] = float(tr.mean())
    return stats
