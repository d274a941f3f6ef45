"""Dataset pipelines (``nclt_slam_tpu/datasets/``): NCLT loaders and
calibration, LiDAR ICP odometry, loop closure + pose-graph optimization,
IMU / point-cloud / GPS utilities."""

from nclt_slam_tpu_torch.datasets import calibration, loaders
from nclt_slam_tpu_torch.datasets.slam import icp, loop_closure
from nclt_slam_tpu_torch.datasets.utils import gps, imu_utils, point_cloud

__all__ = [
    "calibration",
    "loaders",
    "icp",
    "loop_closure",
    "gps",
    "imu_utils",
    "point_cloud",
]
