#!/usr/bin/env python3
"""Kernel K4 (``nclt_slam_tpu_torch/csrc/pgo.cu``) on the card: where an
iteration's cycles go, and its time beside other builds of it.

    python3 tools/torch_pgo_probe.py [--against OLD.cu ...] [--no-tile-io]
                                     [--out FILE]
    python3 tools/torch_pgo_probe.py --dense-determinism N [--out FILE]

1. Instruments a copy of ``csrc/pgo.cu``: after each of the kernel's block
   barriers, thread 0 adds the ``clock64`` cycles since the previous one to
   the counter of the phase that barrier ends (clearing the system,
   assembly, the first diagonal factor, the panel rows, the chunk loads,
   the trailing update, the back substitution, the pose update), and
   inside the assembly it stamps its own pose's chain edges, loop scan and
   stores.  The copy is built into ``build/kernels/`` and run at the SLAM
   tool's shape and on the 514-pose check graph (``chip_smoke.pgo_graphs``);
   the cycles are printed per Gauss-Newton iteration.  ``--no-tile-io``
   runs it once more with the trailing update's loads and stores of H
   taken out (the tile starts at zero and is stored only when a value is
   NaN, which keeps its arithmetic): the update phase's cycles without its
   traffic to L2 (the solution is then wrong, and only the cycles count).
2. Times ``csrc/pgo.cu`` and each ``--against`` source (a ``pgo.cu`` with the
   same C entry point that needs no more scratch than the wrapper
   allocates, e.g. an earlier commit's, ``git show
   REV:nclt_slam_tpu_torch/csrc/pgo.cu``; the one-block Gauss-Jordan
   version of 0e74993 includes ``gauss_jordan.cuh``, which is then taken
   from beside it, ``git show
   0e74993:nclt_slam_tpu_torch/csrc/gauss_jordan.cuh``) at the tool's shape
   with CUDA events, in the order
   A B ... B A, each with its largest difference from the plain version.
3. With ``--dense-determinism N`` (and nothing else): the dense
   ``optimize_pose_graph`` (the path ``run_slam`` takes below 400 poses)
   on the unreduced two-lap graph, N times, and N assemblies of its
   gradient g from the same per-edge terms by ``index_add_`` (float
   atomics on CUDA) and by ``index_put_(accumulate=True)`` (a sorted,
   fixed-order sum): how many runs of each differ from the first, and by
   how much.

Needs one CUDA card; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

CSRC = REPO / "nclt_slam_tpu_torch" / "csrc"
PROBE_DIR = REPO / "build" / "probe"
ITERS = chip_smoke.PGO_ITERS
PHASES = {0: "clear", 1: "assembly, the wait for the other poses",
          2: "first diagonal factor",
          3: "panel rows", 4: "chunk loads", 5: "trailing update",
          8: "back substitution", 10: "pose update",
          11: "(thread 0) chain edges", 12: "(thread 0) loop scan",
          13: "(thread 0) stores"}

# (text of csrc/pgo.cu, the same text with a stamp): each barrier's stamp
# names the phase it ends
_STAMPS = [
    ("namespace {\n",
     "__device__ unsigned long long g_prof[16];\nnamespace {\n"
     "#define STAMP(i) do { if (threadIdx.x == 0) { long long t_ = "
     "clock64(); g_prof[i] += t_ - t0_; t0_ = t_; } } while (0)\n"),
    ("float damping) {\n  for (int k = threadIdx.x; k < K; k += kThreads) {",
     "float damping, long long& t0_) {\n"
     "  for (int k = threadIdx.x; k < K; k += kThreads) {"),
    ("      acc_rhs(g, w, e.Ji, e.r);\n    }\n    for (int l = 0; l < L; ++l) {",
     "      acc_rhs(g, w, e.Ji, e.r);\n    }\n    STAMP(11);\n"
     "    for (int l = 0; l < L; ++l) {"),
    ("    const float pr = k == 0 ? prior_w : 0.f;",
     "    STAMP(12);\n    const float pr = k == 0 ? prior_w : 0.f;"),
    ("= D[a][b];\n    }\n  }\n}", "= D[a][b];\n    }\n    STAMP(13);\n  }\n}"),
    ("                         const Shared& sm) {\n  const int nb",
     "                         const Shared& sm, long long& t0_) {\n"
     "  const int nb"),
    ("sm.R, RG, sm.y);\n  __syncthreads();",
     "sm.R, RG, sm.y);\n  __syncthreads(); STAMP(2);"),
    ("rhs, sm.bufA);\n      __syncthreads();",
     "rhs, sm.bufA);\n      __syncthreads(); STAMP(3);"),
    ("sm.bufB);\n          __syncthreads();",
     "sm.bufB);\n          __syncthreads(); STAMP(4);"),
    ("kPitch);\n        }\n        __syncthreads();",
     "kPitch);\n        }\n        __syncthreads(); STAMP(5);"),
    ("const float* RG, const Shared& sm) {",
     "const float* RG, const Shared& sm,\n"
     "                                long long& t0_) {"),
    ("        rhs[c] = s;\n      }\n    }\n    __syncthreads();",
     "        rhs[c] = s;\n      }\n    }\n    __syncthreads(); STAMP(8);"),
    ("p[i] = poses[i];\n  __syncthreads();",
     "p[i] = poses[i];\n  __syncthreads();\n  long long t0_ = clock64();"),
    ("clear_system(H, rhs, n, npad);\n    __syncthreads();",
     "clear_system(H, rhs, n, npad);\n    __syncthreads(); STAMP(0);"),
    ("loop_w, K, L, prior_w, damping);\n    __syncthreads();",
     "loop_w, K, L, prior_w, damping, t0_);\n"
     "    __syncthreads(); STAMP(1);"),
    ("cholesky(H, npad, rhs, RG, sm);\n    back_substitute(H, npad, rhs, RG, sm);",
     "cholesky(H, npad, rhs, RG, sm, t0_);\n"
     "    back_substitute(H, npad, rhs, RG, sm, t0_);"),
    ("p[i] += rhs[i];\n    __syncthreads();",
     "p[i] += rhs[i];\n    __syncthreads(); STAMP(10);"),
]

_READ = '''
extern "C" int pgo_prof(unsigned long long* host, int reset) {
  if (reset) {
    unsigned long long z[16] = {0};
    return static_cast<int>(cudaMemcpyToSymbol(g_prof, z, sizeof(z)));
  }
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, g_prof, 16 * sizeof(unsigned long long)));
}
'''


# the trailing update's tile traffic, and its replacement for --no-tile-io
_TILE_IO = [
    ("      const float2 c = *reinterpret_cast<const float2*>(\n"
     "          C + static_cast<size_t>(8 * i) * ld + 8 * j);",
     "      const float2 c = make_float2(0.f, 0.f);"),
    ("      *reinterpret_cast<float2*>(C + static_cast<size_t>(8 * i) * ld + "
     "8 * j) =",
     "      if (isnan(acc[i][2 * j]))\n"
     "      *reinterpret_cast<float2*>(C + static_cast<size_t>(8 * i) * ld + "
     "8 * j) ="),
]


def _apply(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"torch_pgo_probe: csrc/pgo.cu no longer has "
                             f"exactly one {old[:50]!r}; update the probe")
        src = src.replace(old, new)
    return src


def instrumented_source(no_tile_io: bool = False) -> Path:
    src = (CSRC / "pgo.cu").read_text()
    if no_tile_io:
        src = _apply(src, _TILE_IO)
    for old, new in _STAMPS:
        if src.count(old) != 1:
            raise SystemExit(f"torch_pgo_probe: csrc/pgo.cu no longer has "
                             f"exactly one {old[:50]!r}; update _STAMPS")
        src = src.replace(old, new)
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    out = PROBE_DIR / ("pgo_phases_no_tile_io.cu" if no_tile_io
                       else "pgo_phases.cu")
    out.write_text(src + _READ)
    return out


def use(source: Path):
    """Point the wrapper at ``source`` and load its build."""
    from nclt_slam_tpu_torch.ops import pgo as ops_pgo
    ops_pgo.SOURCE = source
    ops_pgo._lib = None
    return ops_pgo._load()


def phases(graphs, no_tile_io: bool = False) -> dict:
    import torch
    from nclt_slam_tpu_torch.datasets.slam import loop_closure as lc

    lib = use(instrumented_source(no_tile_io))
    lib.pgo_prof.argtypes = [ctypes.c_void_p, ctypes.c_int]
    rows = {}
    for name in ("tool_shape", "large"):
        graph, w = graphs[name]
        lc.optimize_pgo(graph, w, iters=ITERS)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 16)()
        lib.pgo_prof(buf, 1)
        lc.optimize_pgo(graph, w, iters=ITERS)
        torch.cuda.synchronize()
        lib.pgo_prof(buf, 0)
        per_iter = {PHASES[i]: buf[i] / ITERS for i in PHASES}
        block = sum(per_iter.values())     # disjoint spans of thread 0
        rows[name] = dict(cycles_per_iter=block, phases=per_iter)
        tag = " (no tile traffic)" if no_tile_io else ""
        print(f"{name}{tag}: {block:.0f} cycles an iteration; " + ", ".join(
            f"{k} {v:.0f}" for k, v in per_iter.items()), flush=True)
    return rows


def compare(graphs, against) -> list:
    import torch
    from nclt_slam_tpu_torch.datasets.slam import loop_closure as lc

    sources = [("csrc/pgo.cu", CSRC / "pgo.cu")]
    for i, path in enumerate(against):
        dst = PROBE_DIR / f"against_{i}" / "pgo.cu"
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(path, dst)
        header = Path(path).parent / "gauss_jordan.cuh"   # 0e74993's
        if header.is_file():
            shutil.copy(header, dst.parent)
        sources.append((str(path), dst))
    graph, w = graphs["tool_shape"]
    ref = lc.optimize_pgo_plain(graph, w, iters=ITERS)
    rows = []
    for label, src in sources + sources[::-1]:
        use(src)
        got = lc.optimize_pgo(graph, w, iters=ITERS)
        ms = chip_smoke.time_cuda(
            lambda: lc.optimize_pgo(graph, w, iters=ITERS), 10)
        err = (got - ref).abs().max().item()
        torch.cuda.synchronize()
        rows.append(dict(source=label, ms=ms, max_abs_err=err))
        print(f"{label}: {ms:.3f} ms at the tool shape x{ITERS}, "
              f"{err:.3e} from plain", flush=True)
    return rows


def dense_determinism(n: int) -> dict:
    import torch
    from nclt_slam_tpu_torch.datasets.slam import loop_closure as lc

    dev = torch.device("cuda", 0)
    graph = lc.PoseGraph2D(*(torch.from_numpy(a).to(dev)
                             for a in chip_smoke.two_lap_graph()[0]))

    def differing(outs):
        bad = [i for i, o in enumerate(outs) if not torch.equal(o, outs[0])]
        return dict(differing=len(bad), of=len(outs), max_abs_diff=max(
            (o - outs[0]).abs().max().item() for o in outs))

    solves = [lc.optimize_pose_graph(graph, iters=15) for _ in range(n)]
    ei, ej, meas, w = lc._edges(graph, 1.0, 10.0)
    x = graph.poses
    r, Ji, Jj = lc._rel_residual(x[ei], x[ej], meas, lc._wrap_atan2)
    w3 = w[:, None, None]
    gi = (w3 * Ji.transpose(1, 2) @ r[..., None])[..., 0]
    gj = (w3 * Jj.transpose(1, 2) @ r[..., None])[..., 0]
    rows = (3 * torch.cat([ei, ej])[:, None]
            + torch.arange(3, device=dev)).reshape(-1)
    vals = torch.cat([gi, gj]).reshape(-1)
    added = [x.new_zeros(3 * x.shape[0]).index_add_(0, rows, vals)
             for _ in range(n)]
    put = [x.new_zeros(3 * x.shape[0]).index_put_((rows,), vals,
                                                  accumulate=True)
           for _ in range(n)]
    torch.cuda.synchronize()
    out = dict(optimize_pose_graph=differing(solves),
               g_index_add=differing(added), g_index_put=differing(put))
    for k, v in out.items():
        print(f"{k}: {v['differing']} of {v['of']} runs differ from the "
              f"first, by up to {v['max_abs_diff']:.3e}", flush=True)
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", nargs="*", default=[], type=Path)
    ap.add_argument("--no-tile-io", action="store_true")
    ap.add_argument("--dense-determinism", type=int, metavar="N")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_pgo_probe: needs a CUDA card", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    if args.dense_determinism:
        result = dict(card=card,
                      dense_determinism=dense_determinism(
                          args.dense_determinism))
    else:
        graphs = chip_smoke.pgo_graphs(torch.device("cuda", 0))
        result = dict(card=card, phases=phases(graphs),
                      times=compare(graphs, args.against))
    if args.no_tile_io:
        result["phases_no_tile_io"] = phases(graphs, no_tile_io=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
