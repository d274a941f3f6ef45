"""ROVER-dataset preparation tools — RGB-D association + fisheye
rectification (``nclt_slam_tpu/io/rover.py``).

- ``associate_rgbd``: greedy nearest-timestamp RGB<->depth pairing with a
  max-difference gate and a TUM-style association table
  (``datasets/rover/scripts/prepare_rover_rgbd.py:40-115``).
- ``fisheye_rectify_maps`` + ``remap_bilinear``: Kannala-Brandt ("OpenCV
  fisheye") stereo undistortion to a synthetic pinhole camera — what
  ``rectify_t265_stereo.py:64-120`` does with
  ``cv2.fisheye.initUndistortRectifyMap``: map construction is closed-form
  numpy; the per-image bilinear remap is a gather on tensors on the
  caller's device.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["associate_rgbd", "write_association", "fisheye_rectify_maps",
           "remap_bilinear"]


def associate_rgbd(rgb_t, depth_t, max_diff_s: float = 0.005):
    """Pair every RGB timestamp with the nearest depth timestamp.

    Returns (rgb_idx, depth_idx) index arrays of equal length, keeping only
    pairs within ``max_diff_s`` and enforcing injectivity on the depth side
    (first RGB claim wins — the reference's greedy sorted merge).
    """
    rgb_t = np.asarray(rgb_t, np.float64)
    depth_t = np.asarray(depth_t, np.float64)
    order = np.argsort(depth_t)
    ds = depth_t[order]
    j = np.searchsorted(ds, rgb_t)
    j0 = np.clip(j - 1, 0, len(ds) - 1)
    j1 = np.clip(j, 0, len(ds) - 1)
    pick = np.where(np.abs(ds[j1] - rgb_t) < np.abs(ds[j0] - rgb_t), j1, j0)
    dt = np.abs(ds[pick] - rgb_t)
    ok = dt <= max_diff_s
    claimed = np.zeros(len(ds), bool)
    rgb_idx, depth_idx = [], []
    for i in np.argsort(dt):          # best pairs claim their depth first
        if ok[i] and not claimed[pick[i]]:
            claimed[pick[i]] = True
            rgb_idx.append(i)
            depth_idx.append(order[pick[i]])
    sel = np.argsort(rgb_idx)
    return (np.asarray(rgb_idx, np.int64)[sel],
            np.asarray(depth_idx, np.int64)[sel])


def write_association(path, rgb_t, rgb_files, depth_t, depth_files,
                      max_diff_s: float = 0.005):
    """Write the TUM-style ``associations.txt`` the reference feeds to
    ORB-SLAM3 rgbd_tum (``t_rgb rgb/f.png t_depth depth/f.png``)."""
    ri, di = associate_rgbd(rgb_t, depth_t, max_diff_s)
    with open(path, "w") as f:
        for a, b in zip(ri, di):
            f.write(f"{rgb_t[a]:.6f} {rgb_files[a]} "
                    f"{depth_t[b]:.6f} {depth_files[b]}\n")
    return len(ri)


def _kb4_theta_d(theta, k):
    t2 = theta * theta
    return theta * (1.0 + k[0] * t2 + k[1] * t2 ** 2
                    + k[2] * t2 ** 3 + k[3] * t2 ** 4)


def fisheye_rectify_maps(K_fish, dist_k4, K_new, out_size):
    """Undistortion maps fisheye->pinhole (Kannala-Brandt k1..k4 model).

    For every output pinhole pixel: ray through K_new^-1, equidistant
    distortion theta_d = theta(1 + k1 th^2 + ... + k4 th^8), projection
    through the fisheye K.  Returns (map_x, map_y) float32 (H, W) source
    coordinates — identical contract to
    ``cv2.fisheye.initUndistortRectifyMap`` with R = I.
    """
    W, H = int(out_size[0]), int(out_size[1])
    K_fish = np.asarray(K_fish, np.float64)
    K_new = np.asarray(K_new, np.float64)
    k = np.asarray(dist_k4, np.float64).reshape(-1)[:4]

    u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                       np.arange(H, dtype=np.float64))
    x = (u - K_new[0, 2]) / K_new[0, 0]
    y = (v - K_new[1, 2]) / K_new[1, 1]
    r = np.hypot(x, y)
    theta = np.arctan(r)
    theta_d = _kb4_theta_d(theta, k)
    scale = np.where(r > 1e-9, theta_d / np.maximum(r, 1e-9), 1.0)
    xd, yd = x * scale, y * scale
    map_x = (K_fish[0, 0] * xd + K_fish[0, 2]).astype(np.float32)
    map_y = (K_fish[1, 1] * yd + K_fish[1, 2]).astype(np.float32)
    return map_x, map_y


def remap_bilinear(img, map_x, map_y):
    """Bilinear resample ``img`` (H, W) or (H, W, C) at float source coords
    (the cv2.remap(INTER_LINEAR) step), on the tensors' device; numpy
    inputs go to the CPU.  Returns a float32 tensor."""
    img = torch.as_tensor(img)
    map_x = torch.as_tensor(map_x).to(img.device)
    map_y = torch.as_tensor(map_y).to(img.device)
    chan = img.dim() == 3
    if not chan:
        img = img[..., None]
    H, W = img.shape[:2]
    x0 = torch.floor(map_x).to(torch.int32)
    y0 = torch.floor(map_y).to(torch.int32)
    fx = (map_x - x0)[..., None]
    fy = (map_y - y0)[..., None]
    inside = ((map_x >= 0) & (map_x <= W - 1.0)
              & (map_y >= 0) & (map_y <= H - 1.0))[..., None]

    def at(yy, xx):
        yy = yy.clamp(0, H - 1).long()
        xx = xx.clamp(0, W - 1).long()
        return img[yy, xx].to(torch.float32)

    out = (at(y0, x0) * (1 - fx) * (1 - fy) + at(y0, x0 + 1) * fx * (1 - fy)
           + at(y0 + 1, x0) * (1 - fx) * fy + at(y0 + 1, x0 + 1) * fx * fy)
    out = torch.where(inside, out, torch.zeros_like(out))
    return out if chan else out[..., 0]
