from nclt_slam_tpu_torch.analysis.plots import (
    plot_campaign_summary,
    plot_drift,
    plot_route_run,
    plot_trajectory_map,
)
from nclt_slam_tpu_torch.analysis.campaign_figures import (
    ROUTE_GROUPS,
    gen_route_readme,
    make_route_animation,
    plot_aggregate_heatmap,
    plot_dev_history,
    plot_route_group_heatmaps,
    plot_three_way,
)

__all__ = [
    "plot_campaign_summary",
    "plot_drift",
    "plot_route_run",
    "plot_trajectory_map",
    "ROUTE_GROUPS",
    "gen_route_readme",
    "make_route_animation",
    "plot_aggregate_heatmap",
    "plot_dev_history",
    "plot_route_group_heatmaps",
    "plot_three_way",
]
