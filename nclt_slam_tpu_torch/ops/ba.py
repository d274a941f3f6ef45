"""Sliding-window bundle adjustment: the wrapper of the hand-written CUDA
kernel.

``solve_ba_cuda(prob, cam, cfg, iters)`` runs ``iters`` damped Gauss-Newton
steps on a batch of windows (``vio/ba.py:BAProblem`` with a leading batch
dimension on every field) in one launch of ``csrc/ba.cu``, one cluster of
thread blocks per window, and returns a ``BAResult``.  It replaces the JAX
package's Pallas TPU kernel ``nclt_slam_tpu/ops/ba_pallas.py:_ba_kernel``
(behind ``solve_ba_pallas``).  Callers go through ``vio/ba.py:solve_ba``,
which sends CPU tensors to the plain PyTorch version ``solve_ba_plain``
beside it; this wrapper takes CUDA tensors only, and launches the kernel or
raises.

As the TPU wrapper does, ``w_rel`` is broadcast to (B, K-1) and a missing
point prior becomes zeros.  Each launch adds one to
``solve_ba_cuda.launches`` and to the count of its call site in
``solve_ba_cuda.site_launches``.

The kernel solves each window with a cluster of ``Plan.cluster`` blocks:
rank r owns the slice of ``landmarks_per_rank`` landmarks from
``r * landmarks_per_rank`` (taken ``chunk`` at a time through shared
memory) and the band of ``keyframes_per_rank`` keyframes from
``r * keyframes_per_rank``; it forms its landmarks' part of the reduced
system, the ranks sum the bands through distributed shared memory, and
every rank factors the whole system (see the source's header).  ``plan``
is that plan.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import NamedTuple

import torch

from nclt_slam_tpu_torch.config import CameraConfig, VioConfig
from nclt_slam_tpu_torch.ops import build

SOURCE = build.CSRC / "ba.cu"
MAX_SMEM_BYTES = 232448

# The kernel's plan (see csrc/ba.cu)
CLUSTER_SIZES = (1, 2, 4, 8)
THREADS = 256              # csrc/ba.cu: kThreads
PANEL = 8                  # the Cholesky's panel width
MAX_CHUNK = 32             # landmarks a chunk (csrc/ba.cu takes at most 32)
WARPS = THREADS // 32
EXTRA_FLOATS, REL_FLOATS = 12, 78
SMS = 132                  # an H100's SMs


class Plan(NamedTuple):
    """How the kernel solves B windows of K keyframes and P landmarks."""
    cluster: int              # C blocks a window
    landmarks_per_rank: int   # Pr = ceil(P / C): rank r's slice from r * Pr
    chunk: int                # Lc landmarks through shared memory at a time
    kept: int                 # landmarks whose Bs^T stays in shared memory
    #                           for the back-substitution: Pr, or Lc (each
    #                           chunk's formed again)
    keyframes_per_rank: int   # Kr = ceil(K / C): rank r's band of rows
    threads: int              # a block
    smem_bytes: int           # dynamic shared memory a block

    def grid(self, B: int) -> int:
        """Thread blocks of a launch over B windows."""
        return B * self.cluster

    def slices(self, P: int) -> list[tuple[int, int]]:
        """Each rank's landmarks [start, stop)."""
        Pr = self.landmarks_per_rank
        return [(min(P, r * Pr), min(P, (r + 1) * Pr))
                for r in range(self.cluster)]

    def bands(self, K: int) -> list[tuple[int, int]]:
        """Each rank's rows [start, stop) of the 6K x 6K reduced system."""
        Kr = self.keyframes_per_rank
        return [(6 * min(K, r * Kr), 6 * min(K, (r + 1) * Kr))
                for r in range(self.cluster)]


def _ceil(x: int, m: int) -> int:
    return -(-x // m)


def padded(K: int) -> int:
    """The reduced system's size 6K padded to whole Cholesky panels."""
    return _ceil(6 * K, PANEL) * PANEL


def smem_bytes(K: int, Pr: int, Lc: int, kept: int) -> int:
    """Shared memory of one rank (csrc/ba.cu:layout): the padded system
    with row stride npad + 4, its rhs, 1 / diag(U) and the substitution
    buffers; Y = Bs^T of ``kept`` landmarks and a chunk's X = (Bs A^-1)^T
    (3 rows a landmark of 6K floats rounded up to 4), the other 12 numbers
    of each observation of a chunk and its landmarks' 9 sums; the poses,
    the relative factors with their weights and costs; the slice's
    landmarks, input positions, priors, inverses and gradients; the warps'
    partial costs and four words."""
    npad = padded(K)
    ld = npad + 4
    n6p = _ceil(6 * K, 4) * 4
    return 4 * (npad * ld + 2 * npad + 4 * PANEL + 3 * (kept + Lc) * n6p
                + EXTRA_FLOATS * K * Lc + 9 * Lc + 16 * K
                + (REL_FLOATS + 2) * (K - 1) + 16 * Pr + WARPS + 4)


def plan(B: int, K: int, P: int, cluster: int | None = None) -> Plan:
    """The kernel's plan for B windows of K keyframes and P landmarks.

    C is ``cluster``, or the largest cluster size with B * C <= 132 blocks
    (one block an SM: the rollout's 15 windows get 8, the batch
    benchmark's 64 get 2), halved while the last landmark slice would be
    empty.  A rank's slice goes through shared memory in chunks of at most
    32 landmarks, as even as they come, halved until the rank fits the
    card's 232448 bytes; the whole slice's Bs^T stays for the
    back-substitution where it fits beside them.  Raises ``ValueError`` for a window that does
    not fit even then (its reduced system alone: 40 keyframes need 266 KB)."""
    if cluster is None:
        C = max([c for c in CLUSTER_SIZES if B * c <= SMS] or [1])
    elif cluster in CLUSTER_SIZES:
        C = cluster
    else:
        raise ValueError(f"solve_ba kernel: cluster of {cluster} blocks "
                         f"(takes {CLUSTER_SIZES})")
    while C > 1 and (C - 1) * _ceil(P, C) >= P:
        C //= 2
    Pr = _ceil(P, C)
    Kr = _ceil(K, C)
    Lc = _ceil(Pr, _ceil(Pr, MAX_CHUNK))
    while Lc > 1 and smem_bytes(K, Pr, Lc, Lc) > MAX_SMEM_BYTES:
        Lc = _ceil(Lc, 2)
    kept = Pr if smem_bytes(K, Pr, Lc, Pr) <= MAX_SMEM_BYTES else Lc
    smem = smem_bytes(K, Pr, Lc, kept)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"solve_ba kernel: a ({K}, {P}) window does not fit "
                         f"shared memory ({smem} bytes a block at C = {C})")
    return Plan(C, Pr, Lc, kept, Kr, THREADS, smem)


_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


def build_library() -> Path:
    """Compile ``csrc/ba.cu`` into ``build/kernels/`` and return the
    library's path."""
    return build.build_library(SOURCE)


def bind(lib):
    """Set the argument types of ``lib``'s entry points (a build of
    ``csrc/ba.cu``)."""
    lib.ba_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.ba_smem_bytes.restype = ctypes.c_int
    fn = lib.ba_solve
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 9 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    occ = lib.ba_max_active_clusters
    occ.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    occ.restype = ctypes.c_int
    empty = lib.ba_empty_launch
    empty.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    empty.restype = ctypes.c_int
    return lib


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = bind(ctypes.CDLL(str(build_library())))
    return _lib


def launch(prob, cam: CameraConfig, cfg: VioConfig, iters: int, p: Plan,
           lib=None):
    """One launch of the kernel (``lib``, default the package's build) with
    plan ``p`` on checked CUDA tensors; returns a ``BAResult``.  Counts
    nothing: ``solve_ba_cuda`` is the entry point."""
    from nclt_slam_tpu_torch.vio.ba import BAResult, broadcast_w_rel

    B, K, _ = prob.kf_pos.shape
    P = prob.points.shape[1]
    dev = prob.kf_pos.device
    lib = _load() if lib is None else lib
    if max_active_clusters(p, lib) == 0:
        raise ValueError(f"solve_ba kernel: the card holds no cluster of the "
                         f"plan {p}")
    w_rel = broadcast_w_rel(prob.w_rel, B, K - 1, dev)
    prior = prob.pt_prior_w if prob.pt_prior_w is not None else \
        torch.zeros(B, P, device=dev)
    tensors = [t.contiguous() for t in (
        prob.kf_pos, prob.kf_quat, prob.points, prob.obs_uv, prob.obs_z,
        prob.obs_w, prob.rel_dp, prob.rel_dq, w_rel, prior)]
    out_pos = torch.empty_like(tensors[0])
    out_quat = torch.empty_like(tensors[1])
    out_pts = torch.empty_like(tensors[2])
    out_cost = torch.empty(B, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ba_solve(
            *(t.data_ptr() for t in tensors), B, K, P, int(iters),
            cam.fx, cam.fy, cam.cx, cam.cy, cam.cam_offset_fwd,
            cam.cam_offset_up, cam.depth_noise_rel_per_m, cfg.huber_px,
            cfg.lm_damping, p.cluster, p.landmarks_per_rank, p.chunk,
            p.kept, p.keyframes_per_rank, p.threads, p.smem_bytes,
            out_pos.data_ptr(), out_quat.data_ptr(), out_pts.data_ptr(),
            out_cost.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"solve_ba kernel launch failed: CUDA error {err}")
    return BAResult(kf_pos=out_pos, kf_quat=out_quat, points=out_pts,
                    final_cost=out_cost)


def kernel_smem_bytes(p: Plan, K: int) -> int:
    """The kernel's own count of the shared memory of plan ``p`` (the card
    build's ``ba_smem_bytes``): equal to ``p.smem_bytes``."""
    return _load().ba_smem_bytes(K, p.landmarks_per_rank, p.chunk, p.kept)


_clusters_held = {}


def max_active_clusters(p: Plan, lib=None) -> int:
    """Clusters of plan ``p`` the card holds at once (``lib``, default the
    package's build; asked once a plan): the windows of one launch run in
    one wave when there are no more of them than this."""
    lib = _load() if lib is None else lib
    key = (id(lib), p.cluster, p.smem_bytes)
    if key not in _clusters_held:
        n = ctypes.c_int(0)
        err = lib.ba_max_active_clusters(p.cluster, p.smem_bytes,
                                         ctypes.byref(n))
        if err != 0:
            raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: "
                               f"CUDA error {err}")
        _clusters_held[key] = n.value
    return _clusters_held[key]


def empty_launch(B: int, p: Plan):
    """Launch an empty kernel with the grid, cluster, block and shared
    memory of a launch on B windows under plan ``p``: the launch floor."""
    err = _load().ba_empty_launch(B, p.cluster, p.smem_bytes,
                                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")


def solve_ba_cuda(prob, cam: CameraConfig, cfg: VioConfig,
                  iters: int | None = None, site: str = "other"):
    """The kernel on a batch of windows on the card.  ``prob`` has passed
    ``vio/ba.py:_check`` (shapes, float32, one device)."""
    dev = prob.kf_pos.device
    if dev.type != "cuda":
        raise ValueError(f"solve_ba_cuda: unsupported device {dev}")
    B, K, _ = prob.kf_pos.shape
    P = prob.points.shape[1]
    n_iter = int(iters or cfg.gn_iters)
    if B == 0 or P == 0:
        raise ValueError(f"solve_ba: empty problem ({B} windows, {P} points)")
    out = launch(prob, cam, cfg, n_iter, plan(B, K, P))
    with _count_lock:   # shards of a mesh launch from several threads
        solve_ba_cuda.launches += 1
        solve_ba_cuda.site_launches[site] = \
            solve_ba_cuda.site_launches.get(site, 0) + 1
    return out


def reset_launches():
    solve_ba_cuda.launches = 0
    solve_ba_cuda.site_launches = {}


reset_launches()
