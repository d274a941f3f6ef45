from nclt_slam_tpu_torch.baselines.configs import rgbd_ba, rgbd_no_imu, stock_nav2

__all__ = ["rgbd_ba", "rgbd_no_imu", "stock_nav2"]
