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

The kernel relaxes each grid with a cluster of ``CLUSTER`` = 8 thread
blocks: rank k owns the band of ``ceil(H / 8)`` rows from row
``k * ceil(H / 8)`` and keeps ``halo`` rows of each neighbour band beside
it, runs ``halo`` Jacobi steps alone, then exchanges the edge rows with
its two neighbours through distributed shared memory (see the source's
header).  ``_launch_shape`` is that plan.  It takes every (H, W) with
W <= 1024 whose bands fit shared memory at a halo of one row,
``smem_bytes(ceil(H / 8), 1, W) <= 232448``, with at most 64 rows a
thread; that holds every shape the first, one-block-a-grid
kernel took (W <= 1024, ``(H + 2) * (W + 2) * 4 <= 232448``, at most 64
rows a thread), and more.  Other shapes raise ``ValueError``.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import NamedTuple

import torch

from nclt_slam_tpu_torch.ops import build

BIG = 1e9
DIAG = 1.4142135

SOURCE = build.CSRC / "wavefront.cu"
NVCC_FLAGS = build.BASE_FLAGS + ("--fmad=false",)

# the kernel's plan (see csrc/wavefront.cu): a cluster of CLUSTER blocks a
# grid, each block a band of rows with HALO_DEPTH halo rows a side (fewer
# where the band is shorter or shared memory is short), one thread a column
CLUSTER = 8
HALO_DEPTH = 8
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


class Plan(NamedTuple):
    """How the kernel relaxes an (H, W) grid."""
    cluster: int      # blocks a grid, one band each
    band_rows: int    # R = ceil(H / cluster) grid rows a band
    halo: int         # h: rows kept of each neighbour band, steps a round
    threads_x: int    # W: one thread a column
    threads_y: int    # rows of threads
    rows: int         # local rows a thread relaxes
    smem_bytes: int   # dynamic shared memory a block

    def grid(self, B: int) -> int:
        """Thread blocks of a launch over B grids."""
        return B * self.cluster


def pitch(W: int) -> int:
    """Floats a row of the kernel's buffers takes: column c at 4 + c, BIG
    at c = -1 and c = W, rounded up to a multiple of 4 (float4 rows)."""
    return (W + 8) & ~3


def smem_bytes(band_rows: int, halo: int, W: int) -> int:
    """Shared memory of one block: two (R + 2h, pitch(W)) potential buffers
    and two parities of two h x W halo mailboxes."""
    return 4 * (2 * (band_rows + 2 * halo) * pitch(W) + 4 * halo * W)


def _launch_shape(H: int, W: int, halo: int | None = None) -> Plan:
    """The kernel's plan for an (H, W) grid (``halo`` defaults to
    ``HALO_DEPTH``, cut to the band and to shared memory); raises
    ``ValueError`` if it cannot take the shape."""
    if W > MAX_THREADS:
        raise ValueError(f"wavefront kernel: width {W} > {MAX_THREADS}")
    R = -(-H // CLUSTER)
    h = max(1, min(HALO_DEPTH if halo is None else halo, R))
    while h > 1 and smem_bytes(R, h, W) > MAX_SMEM_BYTES:
        h -= 1
    if smem_bytes(R, h, W) > MAX_SMEM_BYTES:
        raise ValueError(f"wavefront kernel: bands of the ({H}, {W}) grid "
                         f"do not fit {MAX_SMEM_BYTES} bytes of shared "
                         f"memory")
    n_rows = max(1, R + 2 * h - 2)  # local rows a step may relax
    ty = max(1, min(n_rows, MAX_THREADS // max(W, 1)))
    rows = -(-n_rows // ty)
    if rows > MAX_ROWS_PER_THREAD:
        raise ValueError(f"wavefront kernel: ({H}, {W}) needs {rows} rows "
                         f"per thread (max {MAX_ROWS_PER_THREAD})")
    ty = -(-n_rows // rows)         # every row of threads has rows to relax
    return Plan(CLUSTER, R, h, W, ty, rows, smem_bytes(R, h, W))


_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


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
                           *[ctypes.c_int] * 9, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            occ = lib.wavefront_max_active_clusters
            occ.argtypes = [*[ctypes.c_int] * 4, ctypes.c_void_p]
            occ.restype = ctypes.c_int
            _lib = lib
    return _lib


def max_active_clusters(H: int, W: int) -> int:
    """Clusters of the (H, W) plan the card holds at once: the grids of one
    launch run in one wave when there are no more of them than this."""
    plan = _launch_shape(H, W)
    n = ctypes.c_int(0)
    err = _load().wavefront_max_active_clusters(
        W, plan.threads_y, plan.rows, plan.smem_bytes, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: CUDA "
                           f"error {err}")
    return n.value


def wavefront_relax(tc, phi0, n_iter: int):
    """Relaxed potential (B, H, W) from costs ``tc`` and seed ``phi0``.

    CUDA tensors go through the hand-written kernel (a cluster of 8 blocks
    a grid); CPU tensors through ``wavefront_relax_plain``.  Each kernel
    launch adds one to ``wavefront_relax.launches``."""
    _check(tc, phi0, n_iter)
    if tc.device.type == "cpu":
        return wavefront_relax_plain(tc, phi0, n_iter)
    if tc.device.type != "cuda":
        raise ValueError(f"wavefront_relax: unsupported device {tc.device}")
    B, H, W = tc.shape
    plan = _launch_shape(H, W)
    out = torch.empty_like(phi0)
    if out.numel() == 0:
        return out
    lib = _load()
    with torch.cuda.device(tc.device):
        stream = torch.cuda.current_stream(tc.device).cuda_stream
        err = lib.wavefront_relax(tc.data_ptr(), phi0.data_ptr(),
                                  out.data_ptr(), B, H, W, n_iter,
                                  plan.band_rows, plan.halo, plan.threads_y,
                                  plan.rows, plan.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"wavefront kernel launch failed: CUDA error {err}")
    with _count_lock:   # shards of a mesh launch from several threads
        wavefront_relax.launches += 1
    return out


wavefront_relax.launches = 0
