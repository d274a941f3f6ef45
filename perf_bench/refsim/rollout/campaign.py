"""Campaign orchestration: all routes as one batched rollout
(``nclt_slam_tpu/rollout/campaign.py``).

``build_campaign`` stacks the packed scenes and routes along a leading
route dimension on one device; the teach and repeat runners step the whole
batch tick by tick, in equal chunks whose boundaries are the only places
the host waits on the device (the all-routes-done early stop).
``expand_for_ablations`` adds the obstacle-ablation axis (drops / clean)
as more batch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from refsim import config as cfg_mod
from refsim.config import Config
from refsim.eval.metrics import (
    aggregate_metrics,
    procrustes_align_2d,
    route_metrics,
)
from refsim.planning.dispatcher import (
    stock_project_waypoints,
    subsample_waypoints,
)
from refsim.rollout.repeat import (
    RepeatResult,
    RepeatTrace,
    init_repeat_carry,
    run_repeat,
)
from refsim.rollout.scene_pack import pack_route, pack_scene
from refsim.rollout.teach import (
    TeachResult,
    TeachTrace,
    init_teach_carry,
    run_teach,
)
from refsim.scene.colliders import default_scene
from refsim.scene.obstacles import build_drops, no_drops
from refsim.scene.routes import ALL_ROUTES, get_route


@dataclass
class CampaignData:
    """Stacked (leading route dim) static inputs for the batched rollouts."""

    scenes_teach: object   # PackedScene, stacked (no drops)
    scenes_repeat: object  # PackedScene, stacked (with per-route drops)
    routes: object         # PackedRoute, stacked
    names: tuple = ()


def _stack(trees):
    return type(trees[0])(*(torch.stack(xs) for xs in zip(*trees)))


def campaign_device(device=None) -> torch.device:
    """The device a campaign runs on: the CUDA card unless the caller names
    another (``device="cpu"`` for a CPU run).  Raises when no card is
    present and none was named: there is no silent CPU fallback."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "campaign on the CPU")
    return torch.device("cuda")


def build_campaign(route_names=None, seed: int = 7, cfg: Config | None = None,
                   with_drops: bool = True, device=None) -> CampaignData:
    """Pack the routes' scenes and routes, stacked along a leading route
    dimension on ``device`` (default: the CUDA card, see
    ``campaign_device``)."""
    cfg = cfg or cfg_mod.DEFAULT
    device = campaign_device(device)
    names = route_names or ALL_ROUTES
    scene = default_scene(seed)
    routes = [get_route(n, seed) for n in names]
    scenes_teach = _stack([pack_scene(scene, no_drops(), cfg=cfg,
                                      device=device) for _ in routes])
    # session=1: the repeat drive happens under a different appearance
    # epoch than the teach recording (session_shift_bits)
    scenes_repeat = _stack([
        pack_scene(scene, build_drops(r) if with_drops else no_drops(),
                   cfg=cfg, session=1, device=device)
        for r in routes])
    packed_routes = _stack([pack_route(r, cfg, device) for r in routes])
    return CampaignData(scenes_teach=scenes_teach, scenes_repeat=scenes_repeat,
                        routes=packed_routes, names=tuple(names))


def _concat_traces(cls, chunks, n_ticks):
    """Chunk traces -> one trace of numpy arrays, trimmed to n_ticks."""
    return cls(*(torch.cat(xs, 1)[:, :n_ticks].cpu().numpy()
                 for xs in zip(*chunks)))


def planned_chunks(n_ticks: int, chunk: int) -> tuple[int, int]:
    """(n_chunks, chunk) the campaign runners execute for ``n_ticks``:
    equal chunks with minimal overshoot — the executed tick count is
    ``n_chunks * chunk >= n_ticks``, and a benchmark divides by that."""
    n_chunks = -(-n_ticks // min(chunk, n_ticks))
    return n_chunks, -(-n_ticks // n_chunks)


def run_campaign_teach(data: CampaignData, cfg: Config, n_ticks: int,
                       chunk: int = 250, progress=None,
                       stop_when_done: bool = True) -> TeachResult:
    """Batched teach over every route; stops early at a chunk boundary once
    every row of the batch is done (unless ``stop_when_done`` is False),
    whatever ``data.names`` holds."""
    n_chunks, chunk = planned_chunks(n_ticks, chunk)
    carry = init_teach_carry(data.routes, cfg)
    traces = []
    res = None
    for t0 in range(0, n_ticks, chunk):
        res = run_teach(data.scenes_teach, data.routes, cfg, chunk,
                        carry=carry, tick0=t0)
        carry = res.final
        traces.append(res.trace)
        done = res.trace.done[:, -1]
        if progress:
            progress(t0 + chunk, n_ticks, int(done.sum()))
        if stop_when_done and bool(done.all()):
            break
    trace = _concat_traces(TeachTrace, traces, n_ticks)
    n_valid = torch.from_numpy((~trace.done).sum(1).astype(np.int32))
    return TeachResult(trace=trace, teach_grid=res.teach_grid,
                       store=res.store, n_ticks=n_valid, final=res.final)


def teach_waypoints(data: CampaignData, teach: TeachResult, cfg: Config,
                    source: str = "auto"):
    """Teach artefact -> repeat WP lists from the teach run's dense pose
    log subsampled at 4 m.  ``source``: "vio" uses the teach VIO track
    Procrustes-aligned to GT (what the reference's drift monitor writes, so
    the repeat WPs inherit the teach drift); "gt" uses ground truth;
    "auto" picks vio when the teach ran VIO (cfg.teach.run_vio).  Returns
    (wps (B, max_wp, 2), n_wps (B,)) on the routes' device."""
    if source == "auto":
        source = "vio" if cfg.teach.run_vio else "gt"
    if source not in ("vio", "gt"):
        raise ValueError(f"teach_waypoints: unknown source {source!r}")
    gt = np.asarray(teach.trace.gt_xy)        # (R, T, 2)
    vio = np.asarray(teach.trace.vio_xy)
    done = np.asarray(teach.trace.done)
    wps_list, n_list = [], []
    for i in range(gt.shape[0]):
        live = gt[i][~done[i]]
        if source == "vio":
            live = procrustes_align_2d(vio[i][~done[i]], live)
        wps, n = subsample_waypoints(live, len(live), cfg.planner)
        wps_list.append(wps)
        n_list.append(n)
    dev = data.routes.spawn.device
    return (torch.from_numpy(np.stack(wps_list)).to(dev),
            torch.tensor(n_list, dtype=torch.int32, device=dev))


def apply_stock_projection(teach_grids, wps, n_wps, cfg: Config):
    """Stock-baseline client-side WP preparation: when
    ``cfg.planner.stock_follow`` is set, run the one-time teach-map
    projection/drop pass per route on the host
    (waypoint_follower_client._prepare_poses).  No-op for other stacks."""
    if not cfg.planner.stock_follow:
        return wps, n_wps
    tg = teach_grids.cpu().numpy()
    w = wps.cpu().numpy()
    n = n_wps.cpu().numpy()
    out_w, out_n = [], []
    for i in range(w.shape[0]):
        wi, ni = stock_project_waypoints(tg[i], w[i], int(n[i]), cfg.map)
        out_w.append(wi)
        out_n.append(ni)
    return (torch.from_numpy(np.stack(out_w)).to(wps.device),
            torch.tensor(out_n, dtype=torch.int32, device=n_wps.device))


def run_campaign_repeat(data: CampaignData, teach_grids, wps, n_wps,
                        cfg: Config, n_ticks: int, stores=None,
                        chunk: int = 250, progress=None, carry=None,
                        tick0: int = 0, stop_when_done: bool = True,
                        pause=None) -> RepeatResult:
    """Batched repeat, chunked like run_campaign_teach.  ``carry``/``tick0``
    continue a previous run's final state; ``stop_when_done=False`` runs
    exactly ``planned_chunks`` worth of ticks (benchmarking).
    ``pause(tick)``, asked after each chunk that leaves a route running,
    stops the run at that chunk boundary when it returns True: the result
    then holds the ticks run so far and the carry that continues them.
    The stock baseline's one-time WP projection runs here, so that every
    entry point projects (stock mode has no per-WP timeout: a lethal WP
    would block a route for good); it is idempotent."""
    n_chunks, chunk = planned_chunks(n_ticks, chunk)
    wps, n_wps = apply_stock_projection(teach_grids, wps, n_wps, cfg)
    if carry is None:
        carry = init_repeat_carry(data.routes, wps, n_wps, cfg)
    traces = []
    res = None
    for t0 in range(tick0, tick0 + n_ticks, chunk):
        res = run_repeat(data.scenes_repeat, data.routes, teach_grids, wps,
                         n_wps, cfg, chunk, store=stores, carry=carry,
                         tick0=t0)
        carry = res.final
        traces.append(res.trace)
        done = res.trace.done[:, -1]
        if progress:
            progress(t0 + chunk, tick0 + n_ticks, int(done.sum()))
        if stop_when_done and bool(done.all()):
            break
        if pause is not None and pause(t0 + chunk):
            break
    return RepeatResult(trace=_concat_traces(RepeatTrace, traces, n_ticks),
                        final=res.final)


def campaign_metrics(data: CampaignData, repeat: RepeatResult, wps, n_wps,
                     cfg: Config) -> tuple[dict, dict]:
    """Post-hoc metric engine over the batched traces (compute_metrics.py)."""
    gt = np.asarray(repeat.trace.gt_xy)
    nav = np.asarray(repeat.trace.nav_xy)
    wps_np = wps.cpu().numpy()
    n_np = n_wps.cpu().numpy()
    spawn = data.routes.spawn.cpu().numpy()
    turn = data.routes.turnaround.cpu().numpy()
    per_route = {}
    for i, name in enumerate(data.names):
        per_route[name] = route_metrics(
            gt[i], nav[i], wps_np[i][: n_np[i]], spawn[i], turn[i],
            wp_tol=cfg.eval.wp_tol_m, endpoint_tol=cfg.eval.endpoint_tol_m,
            drift_period=cfg.eval.drift_log_period)
    return per_route, aggregate_metrics(per_route)


def expand_for_ablations(data: CampaignData, teach_grids, wps, n_wps,
                         stores=None, ablations=("drops", "clean")):
    """Expand the route batch with an obstacle-ablation axis: each route
    appears once per ablation, with the drop colliders masked out for
    "clean".  Returns (expanded CampaignData, teach_grids, wps, n_wps,
    stores, labels)."""
    reps = len(ablations)

    def tile(tree):
        if isinstance(tree, torch.Tensor):
            return torch.cat([tree] * reps, 0)
        return type(tree)(*(tile(x) for x in tree))

    scenes = []
    for ab in ablations:
        if ab == "drops":
            scenes.append(data.scenes_repeat)
        elif ab == "clean":
            rep = data.scenes_repeat
            scenes.append(rep._replace(valid=rep.valid & ~rep.drop_mask))
        else:
            raise ValueError(f"unknown ablation {ab!r}")
    scenes_rep = type(scenes[0])(*(torch.cat(xs, 0) for xs in zip(*scenes)))

    labels = tuple(f"{n}@{ab}" for ab in ablations for n in data.names)
    expanded = CampaignData(
        scenes_teach=tile(data.scenes_teach), scenes_repeat=scenes_rep,
        routes=tile(data.routes), names=labels)
    out_stores = tile(stores) if stores is not None else None
    return (expanded, tile(teach_grids), tile(wps), tile(n_wps), out_stores,
            labels)
