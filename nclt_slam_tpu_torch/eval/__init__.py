from nclt_slam_tpu_torch.eval.metrics import (
    aggregate_metrics,
    align_umeyama_2d,
    ate_rmse,
    average_precision,
    drift_metrics,
    endpoint_metrics,
    pr_curve,
    procrustes_drift_2d,
    route_metrics,
    rpe_rmse,
    subsample_wps,
    wp_coverage,
)

__all__ = [
    "average_precision",
    "pr_curve",
    "aggregate_metrics",
    "align_umeyama_2d",
    "ate_rmse",
    "drift_metrics",
    "endpoint_metrics",
    "procrustes_drift_2d",
    "route_metrics",
    "rpe_rmse",
    "subsample_wps",
    "wp_coverage",
]
