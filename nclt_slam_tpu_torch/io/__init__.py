"""Artefact I/O of the port (``nclt_slam_tpu/io/``): the reference-format
teach artefacts, shared with the JAX package, and the port's own checkpoint."""

from nclt_slam_tpu_torch.io.artifacts import (
    load_checkpoint,
    load_landmarks_pkl,
    load_teach_map,
    load_traj_gt,
    load_vio_pose_dense,
    save_checkpoint,
    save_landmarks_pkl,
    save_teach_map,
    save_traj_gt,
    save_tum_trajectory,
    save_vio_pose_dense,
)

__all__ = [
    "load_checkpoint",
    "load_landmarks_pkl",
    "load_teach_map",
    "load_traj_gt",
    "load_vio_pose_dense",
    "save_checkpoint",
    "save_landmarks_pkl",
    "save_teach_map",
    "save_traj_gt",
    "save_tum_trajectory",
    "save_vio_pose_dense",
]
