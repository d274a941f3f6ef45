from nclt_slam_tpu_torch.parallel.mesh import (
    pad_batch,
    route_mesh,
    shard_over_routes,
    sharded_campaign_repeat,
)

__all__ = [
    "pad_batch",
    "route_mesh",
    "shard_over_routes",
    "sharded_campaign_repeat",
]
