"""Reduced 2-D pose-graph optimization: the wrapper of the hand-written CUDA
kernel.

``optimize_pgo_cuda(graph, odo_w, iters, lc_w, damping, prior_w)`` runs
``iters`` damped Gauss-Newton steps on one ``PoseGraph2D`` in one launch of
``csrc/pgo.cu`` (one thread block, each step's system by a blocked
Cholesky factorisation) and returns the optimized poses (K, 3).
It replaces the JAX package's Pallas TPU kernel
``nclt_slam_tpu/ops/pgo_pallas.py:_pgo_kernel`` (behind
``optimize_pgo_pallas``).  Callers go through
``datasets/slam/loop_closure.py:optimize_pgo``, which sends CPU tensors to
the plain PyTorch version ``optimize_pgo_plain`` beside it; this wrapper
takes CUDA tensors only, and launches the kernel or raises.

The kernel takes the graph's own K (no lane padding) and loop indices (no
one-hot selectors); ``odo_w`` is broadcast to (K-1,) and the loop weights
are ``lc_w * valid``, as the TPU wrapper builds them.  The system (the
matrix padded to a multiple of 32 unknowns, its right-hand side and the
reciprocals of the factor's diagonal) lives in a scratch tensor allocated
here.  Each launch adds one to
``optimize_pgo_cuda.launches`` and to the count of its call site in
``optimize_pgo_cuda.site_launches``.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from nclt_slam_tpu_torch.ops import build

SOURCE = build.CSRC / "pgo.cu"
# The scratch system takes ~36 K^2 bytes (151 MB at the limit) and the
# kernel's shared memory 117 KB + 12 K bytes (141 KB, within a block's
# 227 KB).
MAX_POSES = 2048
PANEL = 32                # the kernel's panel width (kB in csrc/pgo.cu)

_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


def build_library() -> Path:
    """Compile ``csrc/pgo.cu`` into ``build/kernels/`` and return the
    library's path."""
    return build.build_library(SOURCE)


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            fn = lib.pgo_solve
            fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                           + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 3)
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def optimize_pgo_cuda(graph, odo_w, iters: int = 15, lc_w: float = 10.0,
                      damping: float = 1e-3, prior_w: float = 1e4,
                      site: str = "other") -> torch.Tensor:
    """The kernel on one graph on the card.  ``graph`` has passed
    ``loop_closure._check_graph`` (shapes, one device)."""
    dev = graph.poses.device
    if dev.type != "cuda":
        raise ValueError(f"optimize_pgo_cuda: unsupported device {dev}")
    if graph.poses.dtype != torch.float32:
        raise TypeError(f"optimize_pgo kernel takes float32 poses, got "
                        f"{graph.poses.dtype}")
    K = graph.poses.shape[0]
    L = graph.loop_i.shape[0]
    if K > MAX_POSES:
        raise ValueError(f"optimize_pgo kernel: {K} poses (at most "
                         f"{MAX_POSES})")
    lib = _load()
    f32 = dict(dtype=torch.float32, device=dev)
    odo_w = torch.as_tensor(odo_w, **f32).expand(K - 1)
    loop_w = lc_w * graph.loop_valid.to(torch.float32)
    tensors = [graph.poses, graph.odo_meas.to(torch.float32), odo_w,
               graph.loop_i.to(torch.int32), graph.loop_j.to(torch.int32),
               graph.loop_meas.to(torch.float32), loop_w]
    tensors = [t.contiguous() for t in tensors]
    npad = -(-3 * K // PANEL) * PANEL
    scratch = torch.empty(npad * (npad + 2), **f32)
    out = torch.empty(K, 3, **f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pgo_solve(*(t.data_ptr() for t in tensors), K, L,
                            int(iters), float(prior_w), float(damping),
                            scratch.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"optimize_pgo kernel launch failed: CUDA error "
                           f"{err}")
    with _count_lock:   # shards of a mesh launch from several threads
        optimize_pgo_cuda.launches += 1
        optimize_pgo_cuda.site_launches[site] = \
            optimize_pgo_cuda.site_launches.get(site, 0) + 1
    return out


def reset_launches():
    optimize_pgo_cuda.launches = 0
    optimize_pgo_cuda.site_launches = {}


reset_launches()
