"""Reference-format artefact interop (``nclt_slam_tpu/io/artifacts.py``).

The teach artefact set of the reference: ``landmarks.pkl``
(visual_landmark_recorder.py:313-325 pickle layout), ``teach_map.{pgm,yaml}``
(teach_run_depth_mapper.save: P5 PGM with 0/205/254 trinary, flipped rows,
+ map-server YAML), ``vio_pose_dense.csv`` (vio_drift_monitor writer
columns), ``traj_gt.csv`` and a TUM trajectory.  The writers take tensors
on any device (or numpy arrays) and write the same bytes as the JAX
package's; either package reads the other's files.  These files are the
interchange between the two packages.

The checkpoint is not: ``save_checkpoint`` / ``load_checkpoint`` snapshot
the port's own state (NamedTuples, tuples, lists and dicts of tensors) as
an ``.npz`` of leaves plus a JSON structure spec, read back without
unpickling anything.  A checkpoint belongs to the package that wrote it:
the JAX package's pickles a JAX tree definition, which only JAX can read,
and ``load_checkpoint`` refuses one.
"""

from __future__ import annotations

import csv
import importlib
import json
import pickle
import zipfile
from pathlib import Path

import numpy as np
import torch

from nclt_slam_tpu_torch.config import CameraConfig, LandmarkConfig, MapConfig
from nclt_slam_tpu_torch.landmarks.store import LandmarkStore, init_store

BASE_TO_CAM_TRANSLATION = [0.35, 0.0, 0.18]
BASE_TO_CAM_ROT = [[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]]


def _host(x) -> np.ndarray:
    """A tensor on any device, or an array-like, as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# landmarks.pkl
# ---------------------------------------------------------------------------

def save_landmarks_pkl(store: LandmarkStore, path, cam: CameraConfig,
                       cfg: LandmarkConfig):
    """A batch-1 LandmarkStore -> the reference pickle layout.  Descriptors
    (int64 holding uint32 words) are re-viewed as the 32-byte-per-feature
    uint8 rows OpenCV ORB produces.  The payload is plain Python and numpy,
    never tensors."""
    if store.count.shape != (1,):
        raise ValueError(f"save_landmarks_pkl takes a store of one route, "
                         f"got a batch of shape {tuple(store.count.shape)}")
    count = int(store.count[0])
    cam_pos = _host(store.cam_pos)[0]
    cam_yaw = _host(store.cam_yaw)[0]
    desc = _host(store.desc)[0].astype(np.uint32)
    p3d = _host(store.p3d_cam)[0]
    uv = _host(store.uv)[0]
    fval = _host(store.feat_valid)[0]
    landmarks = []
    for i in range(count):
        m = fval[i]
        n = int(m.sum())
        half_yaw = 0.5 * cam_yaw[i]
        pose = (float(cam_pos[i, 0]), float(cam_pos[i, 1]),
                float(cam_pos[i, 2]), 0.0, 0.0,
                float(np.sin(half_yaw)), float(np.cos(half_yaw)))
        landmarks.append({
            "pose": pose,
            "descriptors": desc[i][m].view(np.uint8).reshape(n, -1),
            "keypoints_2d": uv[i][m].astype(np.float32),
            "keypoints_3d_cam": p3d[i][m].astype(np.float32),
            "ts": float(i),
            "n_features": n,
        })
    payload = {
        "intrinsics": {"fx": cam.fx, "fy": cam.fy, "cx": cam.cx,
                       "cy": cam.cy, "width": cam.width,
                       "height": cam.height},
        "base_to_cam_translation": BASE_TO_CAM_TRANSLATION,
        "base_to_cam_rot": BASE_TO_CAM_ROT,
        "landmarks": landmarks,
    }
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    return payload


def load_landmarks_pkl(path, cfg: LandmarkConfig, device) -> LandmarkStore:
    """Reference pickle -> a batch-1 LandmarkStore on ``device``, padded to
    capacity; ``last_pos``/``has_last`` stay zero, as the JAX package
    leaves them.  The file is a pickle: load only landmark files that
    this system or the reference wrote."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    L, F, W = cfg.max_landmarks, cfg.feats_per_landmark, cfg.desc_words

    cam_pos = np.zeros((L, 3), np.float32)
    cam_yaw = np.zeros(L, np.float32)
    desc = np.zeros((L, F, W), np.uint32)
    p3d = np.zeros((L, F, 3), np.float32)
    uv = np.zeros((L, F, 2), np.float32)
    fval = np.zeros((L, F), bool)
    nf = np.zeros(L, np.int32)

    lms = payload["landmarks"][:L]
    for i, lm in enumerate(lms):
        pose = lm["pose"]
        cam_pos[i] = pose[:3]
        qz, qw = pose[5], pose[6]
        cam_yaw[i] = 2.0 * np.arctan2(qz, qw)
        n = min(int(lm["n_features"]), F)
        d8 = np.asarray(lm["descriptors"][:n], np.uint8)
        desc[i, :n] = d8.reshape(n, -1).view(np.uint32)[:, :W]
        p3d[i, :n] = lm["keypoints_3d_cam"][:n]
        uv[i, :n] = lm["keypoints_2d"][:n]
        fval[i, :n] = True
        nf[i] = n

    def t(a):
        return torch.from_numpy(a)[None].to(device)

    return init_store(cfg, 1, device)._replace(
        cam_pos=t(cam_pos), cam_yaw=t(cam_yaw),
        desc=t(desc.astype(np.int64)), p3d_cam=t(p3d), uv=t(uv),
        feat_valid=t(fval), n_feats=t(nf),
        count=torch.tensor([len(lms)], dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# teach_map.{pgm,yaml}
# ---------------------------------------------------------------------------

def save_teach_map(trinary, out_prefix, cfg: MapConfig):
    """Trinary occupancy (rows, cols) {0 free, 1 unknown, 2 occupied} ->
    reference PGM (0 occupied / 254 free / 205 unknown, top row first) +
    YAML."""
    grid = _host(trinary)
    img = np.full(grid.shape, 205, np.uint8)
    img[grid == 2] = 0
    img[grid == 0] = 254
    img = np.flipud(img)

    out_prefix = str(out_prefix)
    Path(out_prefix).parent.mkdir(parents=True, exist_ok=True)
    pgm_path = out_prefix + ".pgm"
    with open(pgm_path, "wb") as f:
        f.write(b"P5\n")
        f.write(b"# nclt_slam_tpu teach-run depth map\n")
        f.write(f"{grid.shape[1]} {grid.shape[0]}\n".encode())
        f.write(b"255\n")
        f.write(img.tobytes())

    yaml_path = out_prefix + ".yaml"
    with open(yaml_path, "w") as f:
        f.write(f"image: {pgm_path}\n")
        f.write(f"resolution: {cfg.resolution}\n")
        f.write(f"origin: [{cfg.origin_x}, {cfg.origin_y}, 0.0]\n")
        f.write("occupied_thresh: 0.65\nfree_thresh: 0.25\nnegate: 0\n")
    return pgm_path, yaml_path


def load_teach_map(out_prefix):
    """PGM/YAML -> (trinary int8 grid (rows, cols) as ``occupancy_trinary``
    gives it, resolution, origin).  The grid is numpy; a repeat takes it
    as ``torch.from_numpy(grid)[None].to(device)``."""
    pgm_path = str(out_prefix) + ".pgm"
    with open(pgm_path, "rb") as f:
        if f.readline().strip() != b"P5":
            raise ValueError(f"{pgm_path} is not a P5 PGM")
        line = f.readline()
        while line.startswith(b"#"):
            line = f.readline()
        w, h = map(int, line.split())
        f.readline()  # maxval
        img = np.frombuffer(f.read(w * h), np.uint8).reshape(h, w)
    img = np.flipud(img)
    grid = np.ones((h, w), np.int8)
    grid[img == 0] = 2
    grid[img == 254] = 0

    res, origin = None, None
    lines = Path(str(out_prefix) + ".yaml").read_text().splitlines()
    i = 0
    while i < len(lines):
        line = lines[i]
        if line.startswith("resolution:"):
            res = float(line.split(":")[1])
        elif line.startswith("origin:"):
            rest = line.split(":", 1)[1].strip()
            if rest.startswith("["):
                origin = [float(v) for v in rest.strip("[]").split(",")]
            else:
                # block-style list (the reference's yaml.safe_dump layout)
                origin = []
                while i + 1 < len(lines) and \
                        lines[i + 1].lstrip().startswith("-"):
                    i += 1
                    origin.append(float(lines[i].lstrip()[1:].strip()))
        i += 1
    return grid, res, origin


# ---------------------------------------------------------------------------
# CSV artefacts
# ---------------------------------------------------------------------------

def save_vio_pose_dense(path, ticks_s, slam_xyz_quat, gt_xy):
    """vio_pose_dense.csv with the drift-monitor's exact column layout
    (t_wall, sim_t, vio_x, vio_y, vio_z, qx, qy, qz, qw, gt_x, gt_y) —
    the repeat WP source."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["t_wall", "sim_t", "vio_x", "vio_y", "vio_z",
                    "qx", "qy", "qz", "qw", "gt_x", "gt_y"])
        for t, sp, g in zip(_host(ticks_s), _host(slam_xyz_quat),
                            _host(gt_xy)):
            w.writerow([f"{t:.3f}", f"{t:.1f}", *[f"{v:.6f}" for v in sp],
                        f"{g[0]:.6f}", f"{g[1]:.6f}"])
    return path


def load_vio_pose_dense(path):
    gt = []
    with open(path) as f:
        for row in csv.DictReader(f):
            gt.append((float(row["gt_x"]), float(row["gt_y"])))
    return np.asarray(gt, np.float32)


def save_traj_gt(path, ticks_s, gt_xy, gt_yaw=None):
    """traj_gt.csv (ts, x, y[, yaw]) consumed by compute_metrics."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    gt_xy = _host(gt_xy)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["timestamp", "x", "y", "yaw"])
        yaws = _host(gt_yaw) if gt_yaw is not None else np.zeros(len(gt_xy))
        for t, g, y in zip(_host(ticks_s), gt_xy, yaws):
            w.writerow([f"{t:.3f}", f"{g[0]:.6f}", f"{g[1]:.6f}", f"{y:.6f}"])
    return path


def load_traj_gt(path):
    pts = []
    with open(path) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith(("t", "#")):
                continue
            pts.append((float(row[1]), float(row[2])))
    return np.asarray(pts, np.float32)


def save_tum_trajectory(path, ticks_s, xyz, quat_xyzw):
    """TUM-format trajectory (ts x y z qx qy qz qw) for evo-style tools."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for t, p, q in zip(_host(ticks_s), _host(xyz), _host(quat_xyzw)):
            f.write(f"{t:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")
    return path


# ---------------------------------------------------------------------------
# checkpoint / resume: the port's own format
# ---------------------------------------------------------------------------

CHECKPOINT_FORMAT = "nclt_slam_tpu_torch.checkpoint/1"
_PACKAGE = "nclt_slam_tpu_torch."


def _spec(tree, leaves: list):
    """The JSON structure of ``tree``; its tensors are appended to
    ``leaves`` and named by their index."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree.detach().cpu().numpy())
        return {"t": "tensor", "i": len(leaves) - 1}
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return {"t": "value", "v": tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = type(tree)
        if not cls.__module__.startswith(_PACKAGE):
            raise TypeError(f"cannot checkpoint a {cls.__qualname__}: not a "
                            f"type of nclt_slam_tpu_torch")
        return {"t": "namedtuple",
                "type": f"{cls.__module__}.{cls.__qualname__}",
                "items": {f: _spec(v, leaves)
                          for f, v in zip(tree._fields, tree)}}
    if isinstance(tree, (tuple, list)):
        return {"t": type(tree).__name__,
                "items": [_spec(v, leaves) for v in tree]}
    if isinstance(tree, dict):
        if not all(isinstance(k, str) for k in tree):
            raise TypeError("checkpoint dict keys must be strings")
        return {"t": "dict", "items": {k: _spec(v, leaves)
                                       for k, v in tree.items()}}
    raise TypeError(f"cannot checkpoint a {type(tree).__name__} leaf: "
                    f"tensors, NamedTuples, tuples, lists, dicts only")


def _namedtuple_type(path: str, fields):
    """The NamedTuple class ``path`` names, if it is one of the package's and
    has exactly ``fields``; anything else in a checkpoint (a function, a
    class of another kind) raises before it is called."""
    module, _, name = path.rpartition(".")
    if not module.startswith(_PACKAGE):
        raise ValueError(f"checkpoint names a type outside "
                         f"nclt_slam_tpu_torch: {path}")
    cls = getattr(importlib.import_module(module), name, None)
    if not (isinstance(cls, type) and issubclass(cls, tuple)
            and tuple(getattr(cls, "_fields", ())) == tuple(fields)):
        raise ValueError(f"checkpoint names {path} with fields "
                         f"{list(fields)}: not a NamedTuple of those fields")
    return cls


def _build(spec, leaves, device):
    kind = spec["t"]
    if kind == "tensor":
        return torch.from_numpy(leaves[f"leaf_{spec['i']}"]).to(device)
    if kind == "value":
        return spec["v"]
    if kind == "namedtuple":
        cls = _namedtuple_type(spec["type"], spec["items"])
        return cls(**{f: _build(v, leaves, device)
                      for f, v in spec["items"].items()})
    if kind in ("tuple", "list"):
        seq = [_build(v, leaves, device) for v in spec["items"]]
        return tuple(seq) if kind == "tuple" else seq
    if kind == "dict":
        return {k: _build(v, leaves, device)
                for k, v in spec["items"].items()}
    raise ValueError(f"unknown checkpoint node {kind!r}")


def save_checkpoint(tree, path):
    """Snapshot the port's state (NamedTuples, tuples, lists and dicts of
    tensors, on any device) for an exact resume: a deflated ``.npz`` of
    the tensors, each as its numpy dtype, and a JSON structure spec (the
    occupancy grids and landmark stores are mostly zeros)."""
    leaves: list = []
    spec = _spec(tree, leaves)
    arrays = {f"leaf_{i}": a for i, a in enumerate(leaves)}
    meta = json.dumps({"format": CHECKPOINT_FORMAT, "tree": spec})
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:   # a file object: np.savez keeps the name
        np.savez_compressed(f, __spec__=np.array(meta), **arrays)
    return path


def load_checkpoint(path, device):
    """A checkpoint written by ``save_checkpoint`` -> the same tree with its
    tensors on ``device``.  Read with ``allow_pickle=False``; a file of
    another format (the JAX package's pickled checkpoint among them) raises
    ValueError before anything in it is loaded."""
    if not zipfile.is_zipfile(path):
        raise ValueError(
            f"{path} is not a checkpoint of nclt_slam_tpu_torch (the JAX "
            f"package's checkpoints are pickles that only JAX can read; "
            f"exchange teach state through the reference-format artefacts)")
    with np.load(path, allow_pickle=False) as z:
        if "__spec__" not in z.files:
            raise ValueError(f"{path} is not a checkpoint of "
                             f"nclt_slam_tpu_torch: no structure spec")
        meta = json.loads(str(z["__spec__"]))
        if meta.get("format") != CHECKPOINT_FORMAT:
            raise ValueError(f"{path}: checkpoint format "
                             f"{meta.get('format')!r}, expected "
                             f"{CHECKPOINT_FORMAT!r}")
        leaves = {k: z[k] for k in z.files if k != "__spec__"}
    return _build(meta["tree"], leaves, device)
