from nclt_slam_tpu_torch.scene.colliders import (
    CAPACITY,
    SceneColliders,
    build_scene,
    default_scene,
)
from nclt_slam_tpu_torch.scene.obstacles import DROP_CAP, RouteDrops, build_drops, no_drops
from nclt_slam_tpu_torch.scene.routes import (
    ALL_ROUTES,
    DENSE_CAP,
    ROUTE_META,
    Route,
    get_route,
    get_routes,
)
from nclt_slam_tpu_torch.scene.terrain import (
    road_y,
    terrain_height,
    terrain_normal,
    terrain_pitch_roll,
)

__all__ = [
    "CAPACITY", "SceneColliders", "build_scene", "default_scene",
    "DROP_CAP", "RouteDrops", "build_drops", "no_drops",
    "ALL_ROUTES", "DENSE_CAP", "ROUTE_META", "Route", "get_route", "get_routes",
    "road_y", "terrain_height", "terrain_normal", "terrain_pitch_roll",
]
