"""Mutual-nearest-neighbour Hamming matching: the hand-written CUDA kernel
and its plain PyTorch version.

``cross_check(desc_a, valid_a, desc_b, valid_b, max_dist)`` matches each
row of a descriptor set ``a`` to its nearest row of ``b`` (Hamming distance
over W 32-bit words) and keeps the match when it is mutual and within
``max_dist`` — OpenCV's ``BFMatcher(crossCheck=True)`` under a cap.  It
replaces the JAX package's Pallas TPU kernel
``nclt_slam_tpu/ops/hamming_pallas.py:_cross_check_kernel`` and serves both
of its call sites on the main path: the VIO frame (live features against
the map, every tick) and the anchor matcher (stored landmark features
against the live frame, five candidates per route).

Shapes: ``desc_a`` (P, A, W) and ``desc_b`` (Q, B, W) int64 tensors holding
uint32 values, ``valid_a`` (P, A) and ``valid_b`` (Q, B) bool, with P a
multiple of Q: problem p reads b set ``p // (P // Q)`` (the matcher's
candidates share their route's live frame).  Returns ``best_b`` (P, A)
int32 — the first nearest b among ties —, ``matched`` (P, A) bool and
``best_d`` (P, A) int32; an invalid row gives b = 0, d = BIG, unmatched.

On a CUDA tensor the wrapper launches ``csrc/hamming.cu`` (built with
``nvcc`` on first use) or raises; the plain version runs only for tensors
on the CPU.  Both are bit-exact with the JAX package's XLA path and Pallas
kernel.  Each launch adds one to ``cross_check.launches`` and to the count
of its call site in ``cross_check.site_launches``.

The kernel matches each problem with a cluster of ``Plan.cluster`` thread
blocks: rank r takes the band of ``ceil(A / C)`` a-rows from
``r * ceil(A / C)``, computes each distance of its band once on the tensor
cores (``popc(a) + popc(b) - 2 popc(a & b)``), and merges its partial
column keys into every rank's copy through distributed shared memory
before the mutual test (see the source's header).  ``plan`` is that plan.
It takes every shape that ``_check`` accepts: 8-word descriptors and
``max(A, B) <= 2146`` (the int32 keys), which holds the first kernel's
envelope, ``(A + B) * 37 <= 232448`` bytes of shared memory, and more.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import NamedTuple

import torch

from nclt_slam_tpu_torch.ops import build

BIG = 10 ** 6
INT32_MAX = 2 ** 31 - 1
WORDS = 8          # the kernel's descriptor width (256 bits)
MAX_SMEM_BYTES = 232448

SOURCE = build.CSRC / "hamming.cu"


def popcount32(x):
    """Set bits of 32-bit words (SWAR, exact), held as int32 (two's
    complement: the masks clear every sign-extended bit) or as int64 values
    in [0, 2**32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _as_int32(d):
    """int64 words in [0, 2**32) -> the same 32 bits as int32."""
    return torch.where(d >= 2 ** 31, d - 2 ** 32, d).to(torch.int32)


def hamming_plain(d1, d2):
    """Pairwise Hamming distance (..., A, W) x (..., B, W) -> (..., A, B)
    int32.  The xor and popcount run on int32 words: half the bytes of the
    int64 tensors."""
    x = _as_int32(d1)[..., :, None, :] ^ _as_int32(d2)[..., None, :, :]
    return popcount32(x).sum(-1, dtype=torch.int32)


def _expand_b(desc_b, valid_b, P: int):
    group = P // desc_b.shape[0]
    if group == 1:
        return desc_b, valid_b
    return (desc_b.repeat_interleave(group, 0),
            valid_b.repeat_interleave(group, 0))


def cross_check_plain(desc_a, valid_a, desc_b, valid_b, max_dist: int = 64):
    """The plain PyTorch version: distances, value*index argmin keys, and
    the mutual test by a gather."""
    P, A, _ = desc_a.shape
    desc_b, valid_b = _expand_b(desc_b, valid_b, P)
    B = desc_b.shape[1]
    dev = desc_a.device
    pair = valid_a[:, :, None] & valid_b[:, None, :]
    dm = torch.where(pair, hamming_plain(desc_a, desc_b).to(torch.int64),
                     torch.full((), BIG, dtype=torch.int64, device=dev))
    rowkey = (dm * B + torch.arange(B, device=dev)).amin(2)       # (P, A)
    colkey = (dm * A + torch.arange(A, device=dev)[:, None]).amin(1)  # (P, B)
    best_b = rowkey % B
    best_d = rowkey // B
    mutual = torch.gather(colkey, 1, best_b) == \
        best_d * A + torch.arange(A, device=dev)
    matched = mutual & (best_d <= max_dist) & (best_d < BIG)
    return best_b.to(torch.int32), matched, best_d.to(torch.int32)


def _check(desc_a, valid_a, desc_b, valid_b):
    if desc_a.dim() != 3 or desc_b.dim() != 3:
        raise ValueError("cross_check takes (P, A, W) and (Q, B, W) "
                         f"descriptors; got {tuple(desc_a.shape)} and "
                         f"{tuple(desc_b.shape)}")
    P, A, W = desc_a.shape
    Q, B, Wb = desc_b.shape
    if W != Wb:
        raise ValueError(f"descriptor widths differ: {W} and {Wb}")
    if Q == 0 or P % Q:
        raise ValueError(f"{P} a-problems do not split over {Q} b-sets")
    if valid_a.shape != (P, A) or valid_b.shape != (Q, B):
        raise ValueError("validity shapes do not match the descriptors")
    if desc_a.dtype != torch.int64 or desc_b.dtype != torch.int64:
        raise TypeError("descriptors are int64 tensors holding uint32 words")
    if valid_a.dtype != torch.bool or valid_b.dtype != torch.bool:
        raise TypeError("validity flags are bool tensors")
    if len({t.device for t in (desc_a, valid_a, desc_b, valid_b)}) != 1:
        raise ValueError("cross_check inputs are on different devices")
    n = max(A, B)
    if BIG * n + n > INT32_MAX:
        raise ValueError(f"cross_check: {n} rows overflow the int32 keys")


# The kernel's plan (see csrc/hamming.cu): a cluster of C blocks a
# problem, rank r owning the band of ceil(A / C) a-rows from r * ceil(A / C)
# and a full copy of the column keys merged over the cluster.
CLUSTER_SIZES = (1, 2, 4, 8)
CHUNK_ROWS = 32            # band rows a chunk: two 16-row MMA tiles
TILE_COLS = 8              # b columns an MMA tile
MAX_WARPS = 8              # csrc/hamming.cu: __launch_bounds__(256)


class Plan(NamedTuple):
    """How the kernel matches P problems of A a-rows against B b-rows."""
    cluster: int      # C blocks a problem, one band of a-rows each
    band_rows: int    # R = ceil(A / C)
    pad_rows: int     # the band padded to whole 32-row chunks
    pad_cols: int     # B padded to the 8-column MMA tile
    threads: int      # a block: a warp for each 8 columns, at most 8 warps
    smem_bytes: int   # dynamic shared memory a block

    def grid(self, P: int) -> int:
        """Thread blocks of a launch over P problems."""
        return P * self.cluster


def _ceil(x: int, m: int) -> int:
    return -(-x // m)


def smem_bytes(pad_rows: int, pad_cols: int) -> int:
    """Shared memory of one block: the b set and the band as 32-bit words,
    the popcounts of each column and row, the band's row keys, its partial
    column keys and its copy of the merged column keys."""
    return 4 * (WORDS * (pad_cols + pad_rows) + 3 * pad_cols + 2 * pad_rows)


def plan(P: int, A: int, B: int, cluster: int | None = None) -> Plan:
    """The kernel's plan for P problems of A a-rows against B b-rows.

    C is ``cluster`` (default 8, the fastest at both of the main path's
    shapes on an H100: PERF.md section 6), halved while the last band would
    be empty.  Every (A, B) that ``_check`` accepts fits: max(A, B) <= 2146
    keeps the band, the b set and the key arrays under 190 KB of shared
    memory."""
    C = CLUSTER_SIZES[-1] if cluster is None else cluster
    if C not in CLUSTER_SIZES:
        raise ValueError(f"cross_check kernel: cluster of {C} blocks "
                         f"(takes {CLUSTER_SIZES})")
    while C > 1 and (C - 1) * _ceil(A, C) >= A:
        C //= 2
    R = _ceil(A, C)
    Rp = _ceil(max(R, 1), CHUNK_ROWS) * CHUNK_ROWS
    Bp = _ceil(B, TILE_COLS) * TILE_COLS
    threads = 32 * max(1, min(MAX_WARPS, Bp // TILE_COLS))
    return Plan(C, R, Rp, Bp, threads, smem_bytes(Rp, Bp))


_lib = None
_lib_lock = threading.Lock()


def build_library() -> Path:
    """Compile ``csrc/hamming.cu`` into ``build/kernels/`` and return the
    library's path."""
    return build.build_library(SOURCE)


def bind(lib):
    """Set the argument types of ``lib``'s entry points (a build of
    ``csrc/hamming.cu``)."""
    fn = lib.hamming_cross_check
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 12
                   + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    occ = lib.hamming_max_active_clusters
    occ.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    occ.restype = ctypes.c_int
    empty = lib.hamming_empty_launch
    empty.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    empty.restype = ctypes.c_int
    return lib


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = bind(ctypes.CDLL(str(build_library())))
    return _lib


def _aligned(t):
    """``t`` contiguous with its data 16-byte aligned (the kernel loads the
    descriptors 16 bytes at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch(desc_a, valid_a, desc_b, valid_b, max_dist: int, p: Plan,
           lib=None):
    """One launch of the kernel (``lib``, default the package's build) with
    plan ``p`` on checked CUDA tensors; returns (best_b, matched, best_d).
    Counts nothing: ``cross_check`` is the entry point."""
    P, A, W = desc_a.shape
    Q, B, _ = desc_b.shape
    dev = desc_a.device
    best_b = torch.empty(P, A, dtype=torch.int32, device=dev)
    best_d = torch.empty(P, A, dtype=torch.int32, device=dev)
    matched = torch.empty(P, A, dtype=torch.bool, device=dev)
    tensors = [_aligned(desc_a), valid_a.contiguous(), _aligned(desc_b),
               valid_b.contiguous()]
    lib = _load() if lib is None else lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hamming_cross_check(
            *(t.data_ptr() for t in tensors), P, A, B, W, P // Q,
            int(max_dist), p.cluster, p.band_rows, p.pad_rows, p.pad_cols,
            p.threads, p.smem_bytes, best_b.data_ptr(), matched.data_ptr(),
            best_d.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"cross_check kernel launch failed: CUDA error "
                           f"{err}")
    return best_b, matched, best_d


def max_active_clusters(p: Plan) -> int:
    """Clusters of plan ``p`` the card holds at once: the problems of one
    launch run in one wave when there are no more of them than this."""
    n = ctypes.c_int(0)
    err = _load().hamming_max_active_clusters(
        p.cluster, p.threads, p.smem_bytes, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: CUDA "
                           f"error {err}")
    return n.value


def empty_launch(P: int, p: Plan):
    """Launch an empty kernel with the grid, cluster, block and shared
    memory of a cross-check launch of P problems under plan ``p``: the
    launch floor."""
    err = _load().hamming_empty_launch(
        P, p.cluster, p.threads, p.smem_bytes,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")


def cross_check(desc_a, valid_a, desc_b, valid_b, max_dist: int = 64,
                site: str = "other"):
    """(best_b, matched, best_d), each (P, A).  CUDA tensors go through the
    hand-written kernel (a cluster of blocks a problem, see ``plan``); CPU
    tensors through ``cross_check_plain``.  ``site`` names the caller in
    ``cross_check.site_launches``."""
    _check(desc_a, valid_a, desc_b, valid_b)
    dev = desc_a.device
    if dev.type == "cpu":
        return cross_check_plain(desc_a, valid_a, desc_b, valid_b, max_dist)
    if dev.type != "cuda":
        raise ValueError(f"cross_check: unsupported device {dev}")
    P, A, W = desc_a.shape
    Q, B, _ = desc_b.shape
    if W != WORDS:
        raise ValueError(f"cross_check kernel: {W} words (it takes {WORDS})")
    if P == 0 or A == 0:
        return (torch.empty(P, A, dtype=torch.int32, device=dev),
                torch.empty(P, A, dtype=torch.bool, device=dev),
                torch.empty(P, A, dtype=torch.int32, device=dev))
    if B == 0:
        raise ValueError("cross_check: empty b set")
    out = launch(desc_a, valid_a, desc_b, valid_b, max_dist, plan(P, A, B))
    cross_check.launches += 1
    cross_check.site_launches[site] = cross_check.site_launches.get(site, 0) + 1
    return out


def reset_launches():
    cross_check.launches = 0
    cross_check.site_launches = {}


reset_launches()
