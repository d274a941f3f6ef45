"""Wavefront potential relaxation: the hand-written CUDA kernel and its
plain PyTorch version.

``wavefront_relax(tc, phi0, n_iter)`` runs ``n_iter`` Jacobi iterations of

    phi <- min(phi, min over 8 neighbours n of phi[n] + s_n * tc)

on a batch of (H, W) grids, where ``tc`` is the receiving cell's traversal
cost, s_n is 1 (orthogonal) or 1.4142135 (diagonal), and cells outside the
grid read as BIG = 1e9.  It replaces the JAX package's Pallas TPU kernel
``nclt_slam_tpu/ops/wavefront_pallas.py:_relax_kernel`` and serves both of
the planner's relaxations: the (192, 192) planning window and the
(119, 232) coarse full-map potential.

On a CUDA tensor the wrapper launches ``csrc/wavefront.cu`` (built with
``nvcc`` on first use into ``build/kernels/``) or raises; the plain version
runs only for tensors on the CPU.  Both are bit-exact with the JAX
package's XLA loop and Pallas kernel: the same Jacobi order, fixed trip
count, ``tc * 1.4142135`` rounded once and then added, and ``BIG + tc`` for
an out-of-grid neighbour.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from nclt_slam_tpu_torch.ops import build

BIG = 1e9
DIAG = 1.4142135

SOURCE = build.CSRC / "wavefront.cu"
NVCC_FLAGS = build.BASE_FLAGS + ("--fmad=false",)

# the kernel keeps a (H + 2, W + 2) float32 plane in shared memory and one
# column of threads per grid column (see csrc/wavefront.cu)
MAX_SMEM_BYTES = 232448
MAX_ROWS_PER_THREAD = 64
MAX_THREADS = 1024


def _shift(a, dr: int, dc: int):
    """a shifted by (dr, dc) over the last two dims, the wrapped edge
    poisoned with BIG (``planning/wavefront.py:_neighbor_min``)."""
    a = torch.roll(a, (dr, dc), (-2, -1))
    if dr == 1:
        a[..., 0, :] = BIG
    elif dr == -1:
        a[..., -1, :] = BIG
    if dc == 1:
        a[..., :, 0] = BIG
    elif dc == -1:
        a[..., :, -1] = BIG
    return a


def neighbor_min(phi, tc, diag_scale: float = DIAG):
    """One relaxation sweep: min of phi and, over the 8 neighbours, the
    neighbour's phi plus the step cost into this cell."""
    best = phi
    for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        best = torch.minimum(best, _shift(phi, dr, dc) + tc)
    tcd = tc * diag_scale
    for dr, dc in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
        best = torch.minimum(best, _shift(phi, dr, dc) + tcd)
    return best


def wavefront_relax_plain(tc, phi0, n_iter: int):
    """The plain PyTorch relaxation: ``n_iter`` Jacobi sweeps."""
    phi = phi0
    for _ in range(n_iter):
        phi = torch.minimum(phi, neighbor_min(phi, tc))
    return phi


def _check(tc, phi0, n_iter):
    if tc.shape != phi0.shape or tc.dim() != 3:
        raise ValueError(f"tc and phi0 must both be (B, H, W); got "
                         f"{tuple(tc.shape)} and {tuple(phi0.shape)}")
    if tc.dtype != torch.float32 or phi0.dtype != torch.float32:
        raise TypeError("wavefront_relax takes float32 tensors")
    if tc.device != phi0.device:
        raise ValueError("tc and phi0 are on different devices")
    if not (tc.is_contiguous() and phi0.is_contiguous()):
        raise ValueError("wavefront_relax takes contiguous tensors")
    if n_iter < 0:
        raise ValueError("n_iter must be >= 0")


def _launch_shape(H: int, W: int):
    """(threads per block row, rows of threads, grid rows per thread) the
    kernel uses for an (H, W) grid; raises if it cannot take the shape."""
    if W > MAX_THREADS:
        raise ValueError(f"wavefront kernel: width {W} > {MAX_THREADS}")
    if (H + 2) * (W + 2) * 4 > MAX_SMEM_BYTES:
        raise ValueError(f"wavefront kernel: ({H}, {W}) grid does not fit "
                         f"{MAX_SMEM_BYTES} bytes of shared memory")
    ty = max(1, min(H, MAX_THREADS // W))
    rows = -(-H // ty)
    if rows > MAX_ROWS_PER_THREAD:
        raise ValueError(f"wavefront kernel: ({H}, {W}) needs {rows} rows "
                         f"per thread (max {MAX_ROWS_PER_THREAD})")
    return W, ty, rows


_lib = None
_lib_lock = threading.Lock()


def build_library() -> Path:
    """Compile ``csrc/wavefront.cu`` into ``build/kernels/`` and return
    the library's path."""
    return build.build_library(SOURCE, NVCC_FLAGS)


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            fn = lib.wavefront_relax
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def wavefront_relax(tc, phi0, n_iter: int):
    """Relaxed potential (B, H, W) from costs ``tc`` and seed ``phi0``.

    CUDA tensors go through the hand-written kernel (one block per grid);
    CPU tensors through ``wavefront_relax_plain``.  Each kernel launch adds
    one to ``wavefront_relax.launches``."""
    _check(tc, phi0, n_iter)
    if tc.device.type == "cpu":
        return wavefront_relax_plain(tc, phi0, n_iter)
    if tc.device.type != "cuda":
        raise ValueError(f"wavefront_relax: unsupported device {tc.device}")
    B, H, W = tc.shape
    _, ty, rows = _launch_shape(H, W)
    out = torch.empty_like(phi0)
    if B == 0:
        return out
    lib = _load()
    with torch.cuda.device(tc.device):
        stream = torch.cuda.current_stream(tc.device).cuda_stream
        err = lib.wavefront_relax(tc.data_ptr(), phi0.data_ptr(),
                                  out.data_ptr(), B, H, W, n_iter, ty, rows,
                                  stream)
    if err != 0:
        raise RuntimeError(f"wavefront kernel launch failed: CUDA error {err}")
    wavefront_relax.launches += 1
    return out


wavefront_relax.launches = 0
