#!/usr/bin/env python3
"""Kernel K2 (``nclt_slam_tpu_torch/csrc/wavefront.cu``) on the card: its
time beside other builds and halo depths, where a launch's cycles go, and
what one cluster barrier costs.

    python3 tools/torch_wavefront_probe.py [--against OLD.cu ...]
                                           [--halos 1 8 ...] [--out FILE]

1. Prints each build's registers and spills (``nvcc -Xptxas -v``) and how
   many clusters of the planner's two plans the card holds at once.
2. Times ``csrc/wavefront.cu`` and each ``--against`` source, a cluster
   kernel at each halo depth of ``--halos`` (the plan's own first), at the
   planner's two
   shapes ((15, 192, 192) and (15, 119, 232), 384 iterations) with CUDA
   events, in the order A B ... B A, each launch ``torch.equal`` to the
   plain version.  An ``--against`` source is either an earlier round of
   this kernel (the same C entry point) or the first, one-block-a-grid
   kernel (``git show 40d4ef2:nclt_slam_tpu_torch/csrc/wavefront.cu``),
   called with its own entry point and launch shape.
3. Builds ``csrc/wavefront.cu`` with ``-DWAVEFRONT_PROFILE``: thread 0 of
   every block adds the ``clock64`` cycles of each phase (loading, local
   steps, halo rows out, cluster barrier, halo rows in, writing out) to a
   counter; the cycles are printed per launch (a block's mean) and per
   Jacobi iteration.
4. Runs a bare kernel of 384 cluster barriers on the window's launch
   (15 clusters of 8 blocks, the same threads and shared memory): the
   dependency floor of a halo depth of 1, as time and as cycles a barrier.

Needs one CUDA card; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

PROBE_DIR = REPO / "build" / "probe"
SHAPES = chip_smoke.KERNEL_SHAPES
ITERS = chip_smoke.KERNEL_ITERS
PHASES = ("load", "local steps", "halo rows out", "cluster barrier",
          "halo rows in", "write out")

_BARRIERS = r'''
#include <cuda_runtime.h>
__device__ unsigned long long g_cycles;
__global__ void barriers(int n) {
  const long long t0 = clock64();
  for (int i = 0; i < n; ++i) {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" : : : "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" : : : "memory");
  }
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    atomicAdd(&g_cycles, static_cast<unsigned long long>(clock64() - t0));
  }
}
extern "C" int cluster_barriers(int clusters, int tx, int ty, int smem,
                                int n, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      barriers, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 8;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * 8);
  cfg.blockDim = dim3(tx, ty);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, barriers, n);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
extern "C" int barrier_cycles(unsigned long long* host, int reset) {
  if (reset) {
    unsigned long long z = 0;
    return static_cast<int>(cudaMemcpyToSymbol(g_cycles, &z, sizeof(z)));
  }
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, g_cycles, sizeof(unsigned long long)));
}
'''


def _ok(err, what):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def ptxas_report(source: Path, flags) -> list[str]:
    """The lines of ``nvcc -Xptxas -v`` on each kernel's registers and
    spills."""
    from nclt_slam_tpu_torch.ops import build
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    out = subprocess.run(
        [build.nvcc(), *flags, "-Xptxas", "-v", "-o",
         str(PROBE_DIR / "ptxas.so"), str(source)],
        capture_output=True, text=True)
    if out.returncode != 0:
        raise SystemExit(f"nvcc failed on {source}:\n{out.stderr}")
    lines = out.stderr.splitlines()
    keep = []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
            info = " ".join(x.strip() for x in lines[i + 1:i + 4]
                            if "spill" in x or "registers" in x)
            keep.append(f"{name}: {info}")
    return keep


def load(source: Path, extra=()):
    from nclt_slam_tpu_torch.ops import build
    from nclt_slam_tpu_torch.ops import wavefront as wf
    lib = ctypes.CDLL(str(build.build_library(source,
                                              wf.NVCC_FLAGS + tuple(extra))))
    fn = lib.wavefront_relax
    if b"wavefront_max_active_clusters" in source.read_bytes():
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + \
            [ctypes.c_void_p]
        lib.kind = "cluster"
    else:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p]
        lib.kind = "one block a grid"
    fn.restype = ctypes.c_int
    return lib


def runner(lib, halo=None):
    """A function (tc, phi0, n_iter) -> out through ``lib``'s entry point
    with its own launch shape (``halo`` for the cluster kernel)."""
    import torch
    from nclt_slam_tpu_torch.ops import wavefront as wf

    def run(tc, phi0, n_iter):
        B, H, W = tc.shape
        out = torch.empty_like(phi0)
        stream = torch.cuda.current_stream().cuda_stream
        if lib.kind == "cluster":
            p = wf._launch_shape(H, W, halo=halo)
            err = lib.wavefront_relax(
                tc.data_ptr(), phi0.data_ptr(), out.data_ptr(), B, H, W,
                n_iter, p.band_rows, p.halo, p.threads_y, p.rows,
                p.smem_bytes, stream)
        else:
            ty = max(1, min(H, wf.MAX_THREADS // W))
            err = lib.wavefront_relax(
                tc.data_ptr(), phi0.data_ptr(), out.data_ptr(), B, H, W,
                n_iter, ty, -(-H // ty), stream)
        _ok(err, "wavefront launch")
        return out
    return run


def inputs(device):
    import torch
    from nclt_slam_tpu_torch.ops import wavefront as wf
    g = torch.Generator().manual_seed(0)
    grids = []
    for B, H, W in SHAPES:
        tc = torch.rand(B, H, W, generator=g) * 2.0 + 0.1
        tc[torch.rand(B, H, W, generator=g) < 0.15] = wf.BIG
        phi0 = torch.full((B, H, W), wf.BIG)
        phi0[torch.arange(B), torch.randint(0, H, (B,), generator=g),
             torch.randint(0, W, (B,), generator=g)] = 0.0
        tc, phi0 = tc.to(device), phi0.to(device)
        grids.append((tc, phi0, wf.wavefront_relax_plain(tc, phi0, ITERS)))
    return grids


def compare(grids, variants) -> list:
    import torch
    rows = []
    for label, run in variants + variants[::-1]:
        row = dict(variant=label)
        for (tc, phi0, ref), shape in zip(grids, SHAPES):
            outs = [run(tc, phi0, ITERS) for _ in range(3)]
            torch.cuda.synchronize()
            if not all(torch.equal(o, ref) for o in outs):
                raise SystemExit(f"torch_wavefront_probe: {label} differs "
                                 f"from the plain version at {shape}")
            row["x".join(map(str, shape))] = chip_smoke.time_cuda(
                lambda: run(tc, phi0, ITERS), 20)
        rows.append(row)
        print(f"{label}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in row.items() if k != "variant"),
            flush=True)
    return rows


def phases(grids) -> dict:
    import torch
    from nclt_slam_tpu_torch.ops import wavefront as wf

    lib = load(wf.SOURCE, ("-DWAVEFRONT_PROFILE",))
    lib.wavefront_prof.argtypes = [ctypes.c_void_p, ctypes.c_int]
    run = runner(lib)
    result = {}
    for (tc, phi0, ref), shape in zip(grids, SHAPES):
        run(tc, phi0, ITERS)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 8)()
        _ok(lib.wavefront_prof(buf, 1), "profile reset")
        reps = 5
        for _ in range(reps):
            out = run(tc, phi0, ITERS)
        torch.cuda.synchronize()
        _ok(lib.wavefront_prof(buf, 0), "profile read")
        if not torch.equal(out, ref):
            raise SystemExit("torch_wavefront_probe: the profiled build "
                             f"differs from the plain version at {shape}")
        blocks = buf[7]
        per_launch = {name: buf[i] / blocks for i, name in enumerate(PHASES)}
        total = sum(per_launch.values())
        key = "x".join(map(str, shape))
        result[key] = dict(cycles_per_launch=total, phases=per_launch,
                           cycles_per_iter=total / ITERS,
                           blocks_per_launch=blocks / reps,
                           plan=wf._launch_shape(*shape[1:])._asdict())
        print(f"{key}: {total:.0f} cycles a launch (a block's mean), "
              f"{total / ITERS:.1f} an iteration; " + ", ".join(
                  f"{k} {v:.0f}" for k, v in per_launch.items()), flush=True)
    return result


def barrier_floor() -> dict:
    import torch
    from nclt_slam_tpu_torch.ops import build
    from nclt_slam_tpu_torch.ops import wavefront as wf

    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    src = PROBE_DIR / "cluster_barriers.cu"
    src.write_text(_BARRIERS)
    lib = ctypes.CDLL(str(build.build_library(src, build.BASE_FLAGS)))
    lib.cluster_barriers.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.barrier_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
    B, H, W = SHAPES[0]
    p = wf._launch_shape(H, W)

    def launch(n):
        _ok(lib.cluster_barriers(B, W, p.threads_y, p.smem_bytes, n,
                                 torch.cuda.current_stream().cuda_stream),
            "barrier kernel")

    t_full = chip_smoke.time_cuda(lambda: launch(ITERS), 20)
    t_empty = chip_smoke.time_cuda(lambda: launch(0), 20)
    buf = (ctypes.c_ulonglong * 1)()
    _ok(lib.barrier_cycles(buf, 1), "reset")
    launch(ITERS)
    torch.cuda.synchronize()
    _ok(lib.barrier_cycles(buf, 0), "read")
    cycles = buf[0] / (B * 8) / ITERS
    us = (t_full - t_empty) / ITERS * 1e3
    print(f"cluster barrier: {ITERS} barriers {t_full:.4f} ms (empty launch "
          f"{t_empty:.4f} ms): {us:.3f} us, {cycles:.0f} cycles a barrier "
          f"({B} clusters of 8 x {W * p.threads_y} threads)", flush=True)
    return dict(ms_384=t_full, ms_empty=t_empty, us_per_barrier=us,
                cycles_per_barrier=cycles)


def main() -> int:
    import torch
    from nclt_slam_tpu_torch.ops import wavefront as wf

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", nargs="*", default=[], type=Path)
    ap.add_argument("--halos", nargs="*", default=[1], type=int)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_wavefront_probe: needs a CUDA card", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    result = dict(card=card, ptxas={}, plans={})
    for src in [wf.SOURCE, *args.against]:
        lines = ptxas_report(src, wf.NVCC_FLAGS)
        result["ptxas"][str(src)] = lines
        print(f"{src}:\n  " + "\n  ".join(lines), flush=True)
    for B, H, W in SHAPES:
        plan = wf._launch_shape(H, W)
        n = wf.max_active_clusters(H, W)
        result["plans"][f"{B}x{H}x{W}"] = dict(plan._asdict(),
                                               max_active_clusters=n)
        print(f"plan {B}x{H}x{W}: {plan}, max active clusters {n}",
              flush=True)
    grids = inputs(dev)
    halos = [wf.HALO_DEPTH] + [h for h in args.halos if h != wf.HALO_DEPTH]
    sources = [("csrc/wavefront.cu", wf.SOURCE)]
    for i, src in enumerate(args.against):
        dst = PROBE_DIR / f"against_{i}" / "wavefront.cu"
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_bytes(src.read_bytes())
        sources.append((str(src), dst))
    variants = []
    for label, src in sources:
        lib = load(src)
        if lib.kind == "cluster":
            variants += [(f"{label} h={h}", runner(lib, h)) for h in halos]
        else:
            variants.append((label, runner(lib)))
    result["times"] = compare(grids, variants)
    result["phases"] = phases(grids)
    result["barrier"] = barrier_floor()
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
