"""The traced window: ``torch.profiler`` with CUDA activity only (the
runtime's calls and the device's operations, no event a PyTorch
operator, whose collection would dominate the window), read into device
intervals, launches, busy time and the longest idle gaps."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

NAME_CHARS = 96


@dataclass
class DeviceTrace:
    window_s: float                 # host clock over the traced call
    ops: list                       # (name, start ns, duration ns), by start
    runtime_launches: int           # cudaLaunchKernel* calls on the host
    shapes: dict = field(default_factory=dict)   # recorded launch shapes

    @property
    def kernels(self) -> list:
        return [o for o in self.ops if not o[0].startswith(("Memcpy",
                                                            "Memset"))]

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union of
        the operations' intervals)."""
        busy, end = 0, None
        for _, s, d in self.ops:
            e = s + d
            if end is None or s >= end:
                busy += d
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy * 1e-9

    def device_s(self, part: str) -> tuple[int, float]:
        """(launches, device seconds) of the kernels whose name holds
        ``part``."""
        hits = [d for n, _, d in self.kernels if part in n]
        return len(hits), sum(hits) * 1e-9

    def top_ops(self, n: int = 10) -> list:
        tot = {}
        for name, _, d in self.ops:
            key = name[:NAME_CHARS]
            tot[key] = tot.get(key, 0) + d
        return [[k, v * 1e-9] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The ``n`` longest spans with nothing on the device, each named
        by the operation the host launched to end it."""
        gaps, end = [], None
        for name, s, d in self.ops:
            if end is not None and s > end:
                gaps.append((s - end, name))
            end = s + d if end is None else max(end, s + d)
        gaps.sort(key=lambda g: -g[0])
        return [[f"host until {nm[:NAME_CHARS]}", g * 1e-9]
                for g, nm in gaps[:n]]


def profile_call(fn):
    """Run ``fn()`` under the profiler; (fn's result, DeviceTrace)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops, launches = [], 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            ops.append((ev.name(), ev.start_ns(), ev.duration_ns()))
        elif ev.name().startswith("cudaLaunchKernel"):
            launches += 1
    ops.sort(key=lambda o: o[1])
    return out, DeviceTrace(window_s=wall, ops=ops, runtime_launches=launches)


class ShapeRecorder:
    """Records the launch shapes of the port's kernels K1 and K2 while
    installed, by wrapping the port's own entry points: K1's ``launch``
    in ``ops/hamming.py`` and the planner's ``wavefront_relax``."""

    def __init__(self):
        self.k1, self.k2 = [], []
        self._undo = []

    def __enter__(self):
        import importlib

        hm = importlib.import_module("nclt_slam_tpu_torch.ops.hamming")
        pw = importlib.import_module("nclt_slam_tpu_torch.planning.wavefront")
        launch, relax = hm.launch, pw.wavefront_relax

        def k1(desc_a, valid_a, desc_b, valid_b, *args, **kw):
            self.k1.append((*desc_a.shape[:2], *desc_b.shape))
            return launch(desc_a, valid_a, desc_b, valid_b, *args, **kw)

        def k2(tc, phi0, n_iter):
            self.k2.append((*tc.shape, int(n_iter)))
            return relax(tc, phi0, n_iter)

        hm.launch, pw.wavefront_relax = k1, k2
        self._undo = [(hm, "launch", launch), (pw, "wavefront_relax", relax)]
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._undo:
            setattr(mod, name, fn)
        return False
