"""Route-generation CLI — the generate_routes.py artefact emitter
(``nclt_slam_tpu/cli/generate_routes.py``).

    python -m nclt_slam_tpu_torch.cli.generate_routes --out runs/routes

Writes routes.json (route -> dense waypoint list), per-route CSV drafts,
and the overview plot — the reference's offline route artefact set.  Routes
come from the port's cache (``scene/data``) or its generator on a miss.  A
host tool: it takes no ``--device`` and needs matplotlib for the plot,
which it draws from the scene's collider slots on the host
(``cli.analyze.scene_view``, the slots ``pack_scene`` lays out).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True)
    ap.add_argument("--routes", default="all")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)

    import numpy as np

    from nclt_slam_tpu_torch.analysis import plot_trajectory_map
    from nclt_slam_tpu_torch.cli.analyze import scene_view
    from nclt_slam_tpu_torch.scene import default_scene, get_routes
    from nclt_slam_tpu_torch.scene.routes import ALL_ROUTES

    names = ALL_ROUTES if args.routes == "all" else args.routes.split(",")
    routes = get_routes(names, seed=args.seed)
    out = Path(args.out)
    (out / "drafts").mkdir(parents=True, exist_ok=True)

    plan = {}
    for r in routes:
        pts = np.asarray(r.dense_xy[: r.n_dense])
        plan[r.name] = [[round(float(x), 3), round(float(y), 3)]
                        for x, y in pts]
        with open(out / "drafts" / f"route_{r.name}.csv", "w") as f:
            f.write("x,y\n")
            for x, y in pts:
                f.write(f"{x:.3f},{y:.3f}\n")
        print(f"  {r.name}: {r.n_dense} pts, spawn=({r.spawn[0]:.1f},"
              f"{r.spawn[1]:.1f})")

    (out / "routes.json").write_text(json.dumps(plan))
    plot_trajectory_map(scene_view(default_scene(args.seed)), routes,
                        out / "routes_plan.png", title="planned routes")
    print(f"[generate_routes] wrote {out}/routes.json + drafts + plot")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
