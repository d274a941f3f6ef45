"""Sliding-window bundle adjustment: the wrapper of the hand-written CUDA
kernel.

``solve_ba_cuda(prob, cam, cfg, iters)`` runs ``iters`` damped Gauss-Newton
steps on a batch of windows (``vio/ba.py:BAProblem`` with a leading batch
dimension on every field) in one launch of ``csrc/ba.cu``, one thread block
per window, and returns a ``BAResult``.  It replaces the JAX package's
Pallas TPU kernel ``nclt_slam_tpu/ops/ba_pallas.py:_ba_kernel`` (behind
``solve_ba_pallas``).  Callers go through ``vio/ba.py:solve_ba``, which sends
CPU tensors to the plain PyTorch version ``solve_ba_plain`` beside it; this
wrapper takes CUDA tensors only, and launches the kernel or raises.

As the TPU wrapper does, ``w_rel`` is broadcast to (B, K-1) and a missing
point prior becomes zeros.  Each launch adds one to
``solve_ba_cuda.launches`` and to the count of its call site in
``solve_ba_cuda.site_launches``.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from nclt_slam_tpu_torch.config import CameraConfig, VioConfig
from nclt_slam_tpu_torch.ops import build

SOURCE = build.CSRC / "ba.cu"
HEADERS = (build.CSRC / "gauss_jordan.cuh",)
MAX_SMEM_BYTES = 232448

_lib = None
_lib_lock = threading.Lock()


def build_library() -> Path:
    """Compile ``csrc/ba.cu`` into ``build/kernels/`` and return the
    library's path."""
    return build.build_library(SOURCE, headers=HEADERS)


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            lib.ba_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
            lib.ba_smem_bytes.restype = ctypes.c_int
            fn = lib.ba_solve
            fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                           + [ctypes.c_float] * 9 + [ctypes.c_void_p] * 5)
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def solve_ba_cuda(prob, cam: CameraConfig, cfg: VioConfig,
                  iters: int | None = None, site: str = "other"):
    """The kernel on a batch of windows on the card.  ``prob`` has passed
    ``vio/ba.py:_check`` (shapes, float32, one device)."""
    from nclt_slam_tpu_torch.vio.ba import BAResult, broadcast_w_rel

    dev = prob.kf_pos.device
    if dev.type != "cuda":
        raise ValueError(f"solve_ba_cuda: unsupported device {dev}")
    B, K, _ = prob.kf_pos.shape
    P = prob.points.shape[1]
    n_iter = int(iters or cfg.gn_iters)
    if B == 0 or P == 0:
        raise ValueError(f"solve_ba: empty problem ({B} windows, {P} points)")
    lib = _load()
    if lib.ba_smem_bytes(K, P) > MAX_SMEM_BYTES:
        raise ValueError(f"solve_ba kernel: a ({K}, {P}) window does not fit "
                         "shared memory")
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
            *(t.data_ptr() for t in tensors), B, K, P, n_iter,
            cam.fx, cam.fy, cam.cx, cam.cy, cam.cam_offset_fwd,
            cam.cam_offset_up, cam.depth_noise_rel_per_m, cfg.huber_px,
            cfg.lm_damping, out_pos.data_ptr(), out_quat.data_ptr(),
            out_pts.data_ptr(), out_cost.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"solve_ba kernel launch failed: CUDA error {err}")
    solve_ba_cuda.launches += 1
    solve_ba_cuda.site_launches[site] = \
        solve_ba_cuda.site_launches.get(site, 0) + 1
    return BAResult(kf_pos=out_pos, kf_quat=out_quat, points=out_pts,
                    final_cost=out_cost)


def reset_launches():
    solve_ba_cuda.launches = 0
    solve_ba_cuda.site_launches = {}


reset_launches()
