#!/usr/bin/env python3
"""Kernel K1 (``nclt_slam_tpu_torch/csrc/hamming.cu``) on the card: its
time beside other builds and cluster sizes, where a launch's cycles go,
the launch floor and the wrapper's host cost.

    python3 tools/torch_hamming_probe.py [--against OLD.cu ...]
                                         [--clusters 2 4] [--out FILE]

1. Prints each build's registers and spills (``nvcc -Xptxas -v``), the
   plan at the main path's three shapes (``chip_smoke.HAMMING_SHAPES``)
   and how many clusters of it the card holds at once.
2. Times ``csrc/hamming.cu`` under its own plan and at each cluster size
   of ``--clusters``, and each ``--against`` source, at those shapes, in
   the order A B ... B A, each launch ``torch.equal`` to the plain
   version: ms a launch from a CUDA graph of launches
   (``chip_smoke.time_cuda_graph``: the card's time) and from eager calls
   (CUDA events: the wrapper's host cost, where that is longer).  An
   ``--against`` source is an earlier build of this kernel (the same C
   entry point), the build of the redesign's rounds 1 and 2 (both
   routes, timed each), or the first, one-block-a-problem kernel
   (``git show ce12c94:nclt_slam_tpu_torch/csrc/hamming.cu``), each
   called with its own entry point and launch shape.
3. Times an empty kernel with the grid, cluster, block and shared memory of
   each shape's launch, in a graph and eagerly: the launch floor.
4. Builds ``csrc/hamming.cu`` with ``-DHAMMING_PROFILE``: thread 0 of every
   block adds the ``clock64`` cycles of each phase (loads and popcounts,
   distances and block keys, merge into every rank, cluster barrier,
   mutual test) to a counter; printed per launch (a block's mean).
5. Host microseconds per ``cross_check`` call, with no synchronisation.

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
SHAPES = chip_smoke.HAMMING_SHAPES
PHASES = ("load", "distances and block keys", "merge into every rank",
          "cluster barrier", "mutual test")


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
    """A build of ``source`` bound for its entry point; ``lib.kind`` says
    which: "cluster" (this kernel's), "two routes" (the build of this
    redesign's rounds 1 and 2, whose entry point also takes the route and
    the columns a thread holds), "owner slices" (rounds 3 and 4, which
    also take the columns each rank owns) or "one block a problem" (the
    first kernel)."""
    from nclt_slam_tpu_torch.ops import build
    from nclt_slam_tpu_torch.ops import hamming as hm
    text = source.read_bytes()
    lib = ctypes.CDLL(str(build.build_library(
        source, build.BASE_FLAGS + tuple(extra))))
    fn = lib.hamming_cross_check
    fn.restype = ctypes.c_int
    if b"int tensor, int cols" in text:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 15
                       + [ctypes.c_void_p] * 4)
        lib.kind = "two routes"
    elif b"int Bc, int threads" in text:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 13
                       + [ctypes.c_void_p] * 4)
        lib.kind = "owner slices"
    elif b"hamming_max_active_clusters" in text:
        hm.bind(lib)
        lib.kind = "cluster"
    else:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p] * 4)
        lib.kind = "one block a problem"
    return lib


def _two_route_args(P, A, B, tensor):
    """The launch arguments (C, R, Rp, Bp, Bc, threads, tensor, cols, smem)
    of the rounds-1-and-2 build: C the smallest cluster size with P * C >=
    132 blocks (8 at most, halved while the last band is empty), the band
    padded to 16 rows; on the tensor cores a warp for each 8 columns (8 at
    most), on the CUDA cores 4 columns a thread at most, one for each 128
    of B."""
    from nclt_slam_tpu_torch.ops import hamming as hm
    C = next((c for c in hm.CLUSTER_SIZES if P * c >= 132), 8)
    while C > 1 and (C - 1) * -(-A // C) >= A:
        C //= 2
    R = -(-A // C)
    Rp, Bp, Bc = -(-max(R, 1) // 16) * 16, -(-B // 8) * 8, -(-B // C)
    if tensor:
        cols, threads = 1, 32 * max(1, min(8, Bp // 8))
    else:
        cols = min(4, max(1, -(-B // 128)))
        threads = -(-(-(-B // cols)) // 32) * 32
    return (C, R, Rp, Bp, Bc, threads, int(tensor), cols,
            4 * (8 * (Bp + Rp) + 2 * Bp + 2 * Rp + Bc))


def runner(lib, cluster=None, tensor=True):
    """A function (da, va, db, vb) -> (best_b, matched, best_d) through
    ``lib``'s entry point with its own launch shape (``cluster`` overrides
    this kernel's plan; ``tensor`` picks the route of the two-route
    build)."""
    import torch
    from nclt_slam_tpu_torch.ops import hamming as hm

    def run(da, va, db, vb):
        P, A, W = da.shape
        Q, B, _ = db.shape
        kind = getattr(lib, "kind", "cluster")
        if kind == "cluster":
            p = hm.plan(P, A, B, cluster=cluster)
            return hm.launch(da, va, db, vb, 64, p, lib=lib)
        out = [torch.empty(P, A, dtype=dt, device=da.device)
               for dt in (torch.int32, torch.bool, torch.int32)]
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (da.data_ptr(), va.data_ptr(), db.data_ptr(), vb.data_ptr())
        if kind == "two routes":
            err = lib.hamming_cross_check(
                *ptrs, P, A, B, W, P // Q, 64,
                *_two_route_args(P, A, B, tensor),
                *(o.data_ptr() for o in out), stream)
        elif kind == "owner slices":
            p = hm.plan(P, A, B, cluster=cluster)
            Bc = -(-B // p.cluster)
            smem = p.smem_bytes - 4 * p.pad_cols + 4 * Bc
            err = lib.hamming_cross_check(
                *ptrs, P, A, B, W, P // Q, 64, p.cluster, p.band_rows,
                p.pad_rows, p.pad_cols, Bc, p.threads, smem,
                *(o.data_ptr() for o in out), stream)
        else:
            threads = min(1024, -(-max(A, B) // 32) * 32)
            err = lib.hamming_cross_check(
                *ptrs, P, A, B, W, P // Q, 64, threads,
                *(o.data_ptr() for o in out), stream)
        if err != 0:
            raise RuntimeError(f"cross_check launch: CUDA error {err}")
        return tuple(out)
    return run


def inputs(device):
    """chip_smoke's K1 inputs at each shape, with the plain result."""
    import torch
    from nclt_slam_tpu_torch.ops import hamming as hm
    cases = []
    for shape in SHAPES:
        args = chip_smoke.hamming_inputs(shape, device)
        cases.append((args, hm.cross_check_plain(*args)))
    torch.cuda.synchronize()
    return cases


def compare(cases, variants, reps: int) -> list:
    import torch
    rows = []
    for label, run in variants + variants[::-1]:
        row = dict(variant=label)
        for (args, ref), shape in zip(cases, SHAPES):
            outs = [run(*args) for _ in range(3)]
            torch.cuda.synchronize()
            for out in outs:
                if not all(torch.equal(o, r) for o, r in zip(out, ref)):
                    raise SystemExit(f"torch_hamming_probe: {label} differs "
                                     f"from the plain version at {shape}")
            key = "x".join(map(str, shape))
            row[key] = chip_smoke.time_cuda_graph(lambda: run(*args), reps)
            row[key + " eager"] = chip_smoke.time_cuda(lambda: run(*args),
                                                       reps)
        rows.append(row)
        print(f"{label}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in row.items() if k != "variant"),
            flush=True)
    return rows


def floors(reps: int) -> dict:
    from nclt_slam_tpu_torch.ops import hamming as hm
    out = {}
    for P, A, Q, B in SHAPES:
        p = hm.plan(P, A, B)
        ms = chip_smoke.time_cuda_graph(lambda: hm.empty_launch(P, p), reps)
        eager = chip_smoke.time_cuda(lambda: hm.empty_launch(P, p), reps)
        out[f"{P}x{A}x{Q}x{B}"] = dict(graph_ms=ms, eager_ms=eager)
        print(f"launch floor {P}x{A}x{Q}x{B} (grid {p.grid(P)}, cluster "
              f"{p.cluster}, {p.threads} threads, {p.smem_bytes} B): "
              f"{ms:.4f} ms (eager {eager:.4f})", flush=True)
    return out


def phases(cases) -> dict:
    import torch
    from nclt_slam_tpu_torch.ops import hamming as hm

    lib = load(hm.SOURCE, ("-DHAMMING_PROFILE",))
    lib.hamming_prof.argtypes = [ctypes.c_void_p, ctypes.c_int]
    run = runner(lib)
    result = {}
    for (args, ref), shape in zip(cases, SHAPES):
        run(*args)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 8)()
        chip_smoke.check(lib.hamming_prof(buf, 1) == 0, "profile reset")
        reps = 10
        for _ in range(reps):
            out = run(*args)
        torch.cuda.synchronize()
        chip_smoke.check(lib.hamming_prof(buf, 0) == 0, "profile read")
        if not all(torch.equal(o, r) for o, r in zip(out, ref)):
            raise SystemExit("torch_hamming_probe: the profiled build "
                             f"differs from the plain version at {shape}")
        blocks = buf[7]
        per_launch = {name: buf[i] / blocks for i, name in enumerate(PHASES)}
        total = sum(per_launch.values())
        key = "x".join(map(str, shape))
        result[key] = dict(cycles_per_launch=total, phases=per_launch,
                           blocks_per_launch=blocks / reps)
        print(f"{key}: {total:.0f} cycles a block; " + ", ".join(
            f"{k} {v:.0f}" for k, v in per_launch.items()), flush=True)
    return result


def host_cost(cases, calls: int = 2000) -> dict:
    """Host microseconds per ``cross_check`` call, no synchronisation: the
    checks, the plan, the allocations and the ctypes launch."""
    import torch
    from nclt_slam_tpu_torch.ops import hamming as hm
    out = {}
    for (args, _), shape in zip(cases, SHAPES):
        for _ in range(20):
            hm.cross_check(*args, site="probe")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            hm.cross_check(*args, site="probe")
        us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        out["x".join(map(str, shape))] = us
        print(f"host {shape}: {us:.2f} us a cross_check call", flush=True)
    return out


def main() -> int:
    import torch
    from nclt_slam_tpu_torch.ops import build
    from nclt_slam_tpu_torch.ops import hamming as hm

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", nargs="*", default=[], type=Path)
    ap.add_argument("--clusters", nargs="*", default=[], type=int)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_hamming_probe: needs a CUDA card", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    result = dict(card=card, ptxas={}, plans={})
    for src in [hm.SOURCE, *args.against]:
        lines = ptxas_report(src, build.BASE_FLAGS)
        result["ptxas"][str(src)] = lines
        print(f"{src}:\n  " + "\n  ".join(lines), flush=True)
    for P, A, Q, B in SHAPES:
        p = hm.plan(P, A, B)
        n = hm.max_active_clusters(p)
        result["plans"][f"{P}x{A}x{Q}x{B}"] = dict(p._asdict(),
                                                   max_active_clusters=n)
        print(f"plan {P}x{A}x{Q}x{B}: {p}, max active clusters {n}",
              flush=True)
    cases = inputs(dev)
    lib = hm._load()
    variants = [("csrc/hamming.cu", runner(lib))]
    variants += [(f"csrc/hamming.cu C={c}", runner(lib, cluster=c))
                 for c in args.clusters]
    for i, src in enumerate(args.against):
        dst = PROBE_DIR / f"against_{i}" / "hamming.cu"
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_bytes(src.read_bytes())
        old = load(dst)
        if old.kind == "two routes":
            variants += [(f"{src} tensor cores", runner(old)),
                         (f"{src} popc", runner(old, tensor=False))]
        else:
            variants.append((str(src), runner(old)))
    result["times"] = compare(cases, variants, args.reps)
    result["launch_floor_ms"] = floors(args.reps)
    result["phases"] = phases(cases)
    result["host_us_per_call"] = host_cost(cases)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
