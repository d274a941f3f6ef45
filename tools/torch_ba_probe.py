#!/usr/bin/env python3
"""Kernel K3 (``nclt_slam_tpu_torch/csrc/ba.cu``) on the card: its time
beside other builds and cluster sizes, where a block's cycles go, the
launch floor and the wrapper's host cost.

    python3 tools/torch_ba_probe.py [--against OLD.cu ...]
                                    [--clusters 1 2 4 8] [--out FILE]

1. Prints each build's registers and spills (``nvcc -Xptxas -v``), and the
   plan at the rollout's call (``chip_smoke.BA_ROLLOUT``, 15 windows x 16
   keyframes x 192 landmarks x 3 iterations) and the batch benchmark's
   (``chip_smoke.BA_BENCH``, 64 x 16 x 192 x 8) with the clusters of it
   the card holds at once.
2. Times ``csrc/ba.cu`` under its own plan and at each cluster size of
   ``--clusters``, and each ``--against`` source, at both shapes, in the
   order A B ... B A: ms a launch from a CUDA graph of launches
   (``chip_smoke.time_cuda_graph``: the card's time) and from eager calls
   (CUDA events).  Every launch of the rollout's consistent windows is
   held within the smoke's tolerances of ``solve_ba_plain``, and every
   launch of the benchmark's windows must be finite.  An ``--against``
   source is another build of this kernel with the same C entry points
   and plan, or the one-block-a-window kernel (``git show
   0ec4071:nclt_slam_tpu_torch/csrc/ba.cu``, with its
   ``gauss_jordan.cuh`` beside it), each called with its own launch shape.
3. Times an empty kernel with the grid, cluster, block and shared memory
   of each variant's launch at both shapes, in a graph: the launch floor.
4. ``clock64`` cycles of one block by phase (load and set-up; observations
   and normal blocks; landmark inverses; relative factors and assembly;
   the Schur product; the reduced solve; back-substitution and pose
   update; the cross-rank exchange; and inside the cluster build's reduced
   solve its diagonal tiles, panel columns, trailing updates and back
   substitution, the rest of it under "reduced solve"): thread 0 of every
   block adds the
   cycles since its last stamp to the phase a stamp ends, after a block
   barrier.  The cluster build has the stamps (``-DBA_PROFILE``); the
   one-block kernel gets them in a copy, with a block barrier added before
   each stamp that lacks one.  Printed per block and iteration.
5. Host microseconds per ``solve_ba`` call, with no synchronisation.

Needs one CUDA card; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

PROBE_DIR = REPO / "build" / "probe"
PHASES = ("load and set-up", "observations and normal blocks",
          "landmark inverses", "relative factors and assembly",
          "Schur product", "reduced solve",
          "back-substitution and pose update", "cross-rank exchange",
          "solve: diagonal tiles", "solve: panel columns",
          "solve: trailing update", "solve: back substitution",
          "Schur: thread 0's blocks", "partial cost")
N_PROF = 16                     # counters in g_prof; the last counts blocks

_PROF_MACROS = r'''
__device__ unsigned long long g_prof[16];
#define PROF_INIT long long prof_t = clock64()
#define PROF_STAMP(i)                                     \
  do {                                                    \
    if (threadIdx.x == 0) {                               \
      const long long t_ = clock64();                     \
      atomicAdd(&g_prof[i], (unsigned long long)(t_ - prof_t)); \
      prof_t = t_;                                        \
    }                                                     \
  } while (0)
#define PROF_FLUSH \
  do { if (threadIdx.x == 0) atomicAdd(&g_prof[15], 1ull); } while (0)
'''

_PROF_READ = r'''
extern "C" int ba_prof(unsigned long long* host, int reset) {
  if (reset) {
    unsigned long long z[16] = {0};
    return static_cast<int>(cudaMemcpyToSymbol(g_prof, z, sizeof(z)));
  }
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, g_prof, 16 * sizeof(unsigned long long)));
}
'''

# stamps for the one-block-a-window kernel (the text of csrc/ba.cu at
# 0ec4071, the same text with a stamp); each stamp names the phase it ends
_ONE_BLOCK_STAMPS = [
    ('#include "gauss_jordan.cuh"\n',
     '#include "gauss_jordan.cuh"\n' + _PROF_MACROS),
    ("  extern __shared__ float sm[];\n",
     "  extern __shared__ float sm[];\n  PROF_INIT;\n"),
    ("    // --- phase 1:", "    PROF_STAMP(0);\n    // --- phase 1:"),
    ("    // --- phase 2:",
     "    __syncthreads();\n    PROF_STAMP(1);\n    // --- phase 2:"),
    ("    // --- phase 3:",
     "    __syncthreads();\n    PROF_STAMP(2);\n    // --- phase 3:"),
    ("    // --- phase 4:", "    PROF_STAMP(3);\n    // --- phase 4:"),
    ("    // --- phase 5:", "    PROF_STAMP(4);\n    // --- phase 5:"),
    ("    // --- phase 6:", "    PROF_STAMP(5);\n    // --- phase 6:"),
    ("quat[4 * k + i] = qn[i] * inv;\n    }\n    __syncthreads();\n  }\n",
     "quat[4 * k + i] = qn[i] * inv;\n    }\n    __syncthreads();\n"
     "    PROF_STAMP(6);\n  }\n"),
    ("  if (tid == 0) out_cost[b] = cost;\n}",
     "  if (tid == 0) out_cost[b] = cost;\n  PROF_STAMP(0);\n  PROF_FLUSH;\n}"),
]

_EMPTY_SOURCE = r'''
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
// An empty kernel launched with `grid` blocks of `threads`, clusters of
// `cluster` blocks and `smem` bytes of dynamic shared memory.
extern "C" int empty_launch(int grid, int cluster, int threads, int smem,
                            void* stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, empty_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
'''


def shapes():
    """(name, B, K, P, iters, prior, w_rel) of the two timed calls."""
    B, K, P, iters, prior, w_rel = chip_smoke.BA_ROLLOUT
    Bb, Kb, Pb, itb = chip_smoke.BA_BENCH
    return [("rollout", B, K, P, iters, prior, w_rel),
            ("bench", Bb, Kb, Pb, itb, None, 100.0)]


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


def headers_of(source: Path):
    """The ``csrc`` headers that ``source`` includes, from beside it."""
    return tuple(source.parent / h for h in ("gauss_jordan.cuh",)
                 if f'#include "{h}"'.encode() in source.read_bytes())


def load(source: Path, extra=()):
    """A build of ``source`` bound for its entry point; ``lib.kind`` says
    which: "cluster" (this kernel's) or "one block a window" (the first
    version's, ``git show 0ec4071:nclt_slam_tpu_torch/csrc/ba.cu``)."""
    from nclt_slam_tpu_torch.ops import ba as ops_ba
    from nclt_slam_tpu_torch.ops import build
    lib = ctypes.CDLL(str(build.build_library(
        source, build.BASE_FLAGS + tuple(extra), headers=headers_of(source))))
    if b"ba_max_active_clusters" in source.read_bytes():
        ops_ba.bind(lib)
        lib.kind = "cluster"
    else:
        lib.ba_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.ba_smem_bytes.restype = ctypes.c_int
        fn = lib.ba_solve
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                       + [ctypes.c_float] * 9 + [ctypes.c_void_p] * 5)
        fn.restype = ctypes.c_int
        lib.kind = "one block a window"
    return lib


def launch_shape(lib, B, K, P, cluster=None):
    """(grid, cluster, threads, smem) of ``lib``'s launch on B windows."""
    from nclt_slam_tpu_torch.ops import ba as ops_ba
    if lib.kind == "cluster":
        p = ops_ba.plan(B, K, P, cluster=cluster)
        return p.grid(B), p.cluster, p.threads, p.smem_bytes
    return B, 1, 256, lib.ba_smem_bytes(K, P)


def runner(lib, cluster=None):
    """A function (prob, iters) -> BAResult through ``lib``'s entry point
    with its own launch shape (``cluster`` overrides the plan's)."""
    import torch
    from nclt_slam_tpu_torch import config
    from nclt_slam_tpu_torch.ops import ba as ops_ba
    from nclt_slam_tpu_torch.vio.ba import BAResult, broadcast_w_rel

    cam, cfg = config.DEFAULT.camera, config.DEFAULT.vio

    def run(prob, iters):
        B, K, _ = prob.kf_pos.shape
        P = prob.points.shape[1]
        if lib.kind == "cluster":
            p = ops_ba.plan(B, K, P, cluster=cluster)
            return ops_ba.launch(prob, cam, cfg, iters, p, lib=lib)
        dev = prob.kf_pos.device
        w_rel = broadcast_w_rel(prob.w_rel, B, K - 1, dev)
        prior = prob.pt_prior_w if prob.pt_prior_w is not None else \
            torch.zeros(B, P, device=dev)
        ins = [t.contiguous() for t in (
            prob.kf_pos, prob.kf_quat, prob.points, prob.obs_uv, prob.obs_z,
            prob.obs_w, prob.rel_dp, prob.rel_dq, w_rel, prior)]
        outs = [torch.empty_like(ins[0]), torch.empty_like(ins[1]),
                torch.empty_like(ins[2]), torch.empty(B, device=dev)]
        err = lib.ba_solve(
            *(t.data_ptr() for t in ins), B, K, P, iters, cam.fx, cam.fy,
            cam.cx, cam.cy, cam.cam_offset_fwd, cam.cam_offset_up,
            cam.depth_noise_rel_per_m, cfg.huber_px, cfg.lm_damping,
            *(o.data_ptr() for o in outs),
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"ba_solve launch: CUDA error {err}")
        return BAResult(*outs)
    return run


def inputs(device):
    """(name, prob, iters, plain result) at both shapes."""
    import torch
    from nclt_slam_tpu_torch import config
    from nclt_slam_tpu_torch.vio import ba

    cam, cfg = config.DEFAULT.camera, config.DEFAULT.vio
    cases = []
    for name, B, K, P, iters, prior, w_rel in shapes():
        if name == "rollout":
            prob, _ = chip_smoke.consistent_windows(
                range(B), device, K=K, P=P, w_rel=w_rel, prior=prior)
        else:
            prob = chip_smoke.bench_windows(B, K, P, device)
        # w_rel as a (B, K-1) tensor on the card: a Python float would be
        # copied from the host inside each call, which a graph cannot hold
        prob = prob._replace(w_rel=ba.broadcast_w_rel(
            prob.w_rel, B, K - 1, device).contiguous())
        cases.append((name, prob, iters,
                      ba.solve_ba_plain(prob, cam, cfg, iters=iters)))
    torch.cuda.synchronize()
    return cases


def held(name, out, ref) -> str | None:
    """Why ``out`` fails the smoke's check at case ``name``, or None."""
    import torch
    if not all(torch.isfinite(x).all().item() for x in out):
        return "non-finite output"
    if name != "rollout":
        return None
    err = {f: (getattr(out, f) - getattr(ref, f)).abs().max().item()
           for f in ("kf_pos", "kf_quat", "points")}
    cost = ((out.final_cost - ref.final_cost).abs()
            / ref.final_cost.abs()).max().item()
    if err["kf_pos"] <= chip_smoke.BA_POS_ATOL_M and \
            err["kf_quat"] <= chip_smoke.BA_QUAT_ATOL and \
            err["points"] <= chip_smoke.BA_PTS_ATOL_M and \
            cost <= chip_smoke.BA_COST_RTOL:
        return None
    return f"outside tolerance of plain: {err}, cost {cost} relative"


def compare(cases, variants, reps: int) -> list:
    import torch
    rows = []
    for label, run in variants + variants[::-1]:
        row = dict(variant=label)
        for name, prob, iters, ref in cases:
            outs = [run(prob, iters) for _ in range(3)]
            torch.cuda.synchronize()
            for out in outs:
                why = held(name, out, ref)
                if why:
                    raise SystemExit(f"torch_ba_probe: {label} at {name}: "
                                     f"{why}")
            if not all(torch.equal(a, b) for a, b in zip(outs[0], outs[1])):
                raise SystemExit(f"torch_ba_probe: {label} at {name}: two "
                                 "launches differ")
            row[name] = chip_smoke.time_cuda_graph(
                lambda: run(prob, iters), reps)
            row[name + " eager"] = chip_smoke.time_cuda(
                lambda: run(prob, iters), reps)
        rows.append(row)
        print(f"{label}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in row.items() if k != "variant"),
            flush=True)
    return rows


def empty_lib():
    from nclt_slam_tpu_torch.ops import build
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    src = PROBE_DIR / "ba_empty.cu"
    src.write_text(_EMPTY_SOURCE)
    lib = ctypes.CDLL(str(build.build_library(src)))
    lib.empty_launch.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.empty_launch.restype = ctypes.c_int
    return lib


def floors(libs, reps: int) -> dict:
    import torch
    empty = empty_lib()
    out = {}
    for label, lib, cluster in libs:
        for name, B, K, P, *_ in shapes():
            shape = launch_shape(lib, B, K, P, cluster)

            def go():
                err = empty.empty_launch(
                    *shape, torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"empty launch: CUDA error {err}")
            ms = chip_smoke.time_cuda_graph(go, reps)
            out[f"{label} {name}"] = dict(
                grid=shape[0], cluster=shape[1], threads=shape[2],
                smem=shape[3], graph_ms=ms)
            print(f"launch floor {label} {name} (grid {shape[0]}, cluster "
                  f"{shape[1]}, {shape[2]} threads, {shape[3]} B): "
                  f"{ms:.4f} ms", flush=True)
    return out


def instrumented(source: Path) -> tuple[Path, tuple]:
    """(source to build, extra flags) of the stamped build of ``source``."""
    text = source.read_text()
    if "BA_PROFILE" in text:
        return source, ("-DBA_PROFILE",)
    for old, new in _ONE_BLOCK_STAMPS:
        if text.count(old) != 1:
            raise SystemExit(f"torch_ba_probe: {source} does not have "
                             f"exactly one {old[:50]!r}; no phase stamps")
        text = text.replace(old, new)
    dst = PROBE_DIR / f"stamped_{abs(hash(str(source))) % 10 ** 8}" / "ba.cu"
    dst.parent.mkdir(parents=True, exist_ok=True)
    dst.write_text(text + _PROF_READ)
    for h in headers_of(source):
        (dst.parent / h.name).write_bytes(h.read_bytes())
    return dst, ()


def phases(cases, label, source: Path, cluster=None) -> dict:
    import torch
    src, flags = instrumented(source)
    lib = load(src, flags)
    lib.ba_prof.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ba_prof.restype = ctypes.c_int
    run = runner(lib, cluster)
    result = {}
    for name, prob, iters, ref in cases:
        run(prob, iters)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * N_PROF)()
        chip_smoke.check(lib.ba_prof(buf, 1) == 0, "profile reset")
        reps = 5
        for _ in range(reps):
            out = run(prob, iters)
        torch.cuda.synchronize()
        chip_smoke.check(lib.ba_prof(buf, 0) == 0, "profile read")
        why = held(name, out, ref)
        if why:
            raise SystemExit(f"torch_ba_probe: the stamped build of {label} "
                             f"at {name}: {why}")
        blocks = buf[N_PROF - 1]
        per_iter = {ph: buf[i] / blocks / iters
                    for i, ph in enumerate(PHASES)}
        total = sum(per_iter.values())
        result[name] = dict(cycles_per_iter=total, phases=per_iter,
                            blocks_per_launch=blocks / reps)
        print(f"{label} {name}: {total:.0f} cycles a block and iteration; "
              + ", ".join(f"{k} {v:.0f}" for k, v in per_iter.items()),
              flush=True)
    return result


def host_cost(cases, calls: int = 500) -> dict:
    """Host microseconds per ``solve_ba`` call, no synchronisation: the
    checks, the plan, the allocations and the ctypes launch."""
    import torch
    from nclt_slam_tpu_torch import config
    from nclt_slam_tpu_torch.vio import ba
    cam, cfg = config.DEFAULT.camera, config.DEFAULT.vio
    out = {}
    for name, prob, iters, _ in cases:
        for _ in range(20):
            ba.solve_ba(prob, cam, cfg, iters=iters, site="probe")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            ba.solve_ba(prob, cam, cfg, iters=iters, site="probe")
        us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        out[name] = us
        print(f"host {name}: {us:.2f} us a solve_ba call", flush=True)
    return out


def main() -> int:
    import torch
    from nclt_slam_tpu_torch.ops import ba as ops_ba
    from nclt_slam_tpu_torch.ops import build

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", nargs="*", default=[], type=Path)
    ap.add_argument("--clusters", nargs="*", default=[], type=int)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_ba_probe: needs a CUDA card", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    result = dict(card=card, ptxas={}, plans={})
    sources = [ops_ba.SOURCE]
    for i, src in enumerate(args.against):
        dst = PROBE_DIR / f"against_{i}" / "ba.cu"
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_bytes(src.read_bytes())
        for h in headers_of(src):
            (dst.parent / h.name).write_bytes(h.read_bytes())
        sources.append(dst)
    for label, src in zip(["csrc/ba.cu", *map(str, args.against)], sources):
        lines = ptxas_report(src, build.BASE_FLAGS)
        result["ptxas"][label] = lines
        print(f"{label}:\n  " + "\n  ".join(lines), flush=True)
    libs = [("csrc/ba.cu", load(ops_ba.SOURCE), None)]
    if libs[0][1].kind == "cluster":
        libs += [(f"csrc/ba.cu C={c}", libs[0][1], c) for c in args.clusters]
        for name, B, K, P, *_ in shapes():
            p = ops_ba.plan(B, K, P)
            n = ops_ba.max_active_clusters(p)
            result["plans"][name] = dict(p._asdict(), max_active_clusters=n)
            print(f"plan {name} {B}x{K}x{P}: {p}, max active clusters {n}",
                  flush=True)
    libs += [(str(a), load(s), None)
             for a, s in zip(args.against, sources[1:])]
    cases = inputs(dev)
    variants = [(label, runner(lib, c)) for label, lib, c in libs]
    result["times"] = compare(cases, variants, args.reps)
    result["launch_floor_ms"] = floors(libs, args.reps)
    result["phases"] = {}
    for (label, lib, c), src in zip(
            [x for x in libs if x[2] is None], sources):
        result["phases"][label] = phases(cases, label, src)
    for label, lib, c in libs:
        if c is not None:
            result["phases"][label] = phases(cases, label, ops_ba.SOURCE, c)
    result["host_us_per_call"] = host_cost(cases)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
