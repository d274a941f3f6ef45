"""Multi-card scaling: the route batch split over devices
(``nclt_slam_tpu/parallel/mesh.py``).

The batch axis (route × ablation) is embarrassingly parallel: each route's
rollout reads only its own rows and its own key stream, so the batch is
padded to a multiple of the device count, split into one contiguous shard
a device, and each shard runs the campaign runner on its device from its
own host thread (shards that share a device take turns on it).  No
collective is needed while the routes drive; the
traces and final states are gathered in route order at the end.  A route's
result does not depend on its shard: every route draws from the same
expanded seed (``rollout/repeat.py:init_repeat_carry``).

A mesh is a list of torch devices.  It may name one device more than once
(two shards on one card), and CPU devices stand in for cards in the tests.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext

import numpy as np
import torch

from nclt_slam_tpu_torch.config import Config


def route_mesh(n_devices: int | None = None) -> list[torch.device]:
    """The first ``n_devices`` CUDA devices (all of them by default).
    Raises without a card: a CPU run passes its own list of devices."""
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if not devs:
        raise RuntimeError("no CUDA device: pass mesh=[torch.device('cpu'), "
                           "...] to shard over CPU devices")
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"{n} devices asked for, {len(devs)} present")
    return devs[:n]


def _zip_map(fn, trees):
    """``fn`` over the matching leaves (tensors or arrays) of several trees
    of one structure, given as a list."""
    first = trees[0]
    if isinstance(first, (torch.Tensor, np.ndarray)):
        return fn(trees)
    parts = [_zip_map(fn, xs) for xs in zip(*trees)]
    return type(first)(*parts) if hasattr(first, "_fields") \
        else type(first)(parts)


def pad_batch(tree, multiple: int):
    """Pad every leaf's leading (route) axis up to a multiple so it shards
    evenly; padding replicates the last route (masked out in metrics)."""

    def pad(x):
        rem = (-x.shape[0]) % multiple
        if rem == 0:
            return x
        return torch.cat([x, x[-1:].expand((rem,) + x.shape[1:])], 0)

    return _zip_map(lambda xs: pad(xs[0]), [tree])


def shard_over_routes(tree, mesh):
    """One tree a device of ``mesh``: each leaf's leading axis split into
    contiguous shards in route order, shard i moved to ``mesh[i]``."""
    n = len(mesh)

    def shard(x, i):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"a batch of {b} does not split over {n} "
                             "devices: pad_batch first")
        return x[i * b // n:(i + 1) * b // n].to(mesh[i])

    return [_zip_map(lambda xs, i=i: shard(xs[0], i), [tree])
            for i in range(n)]


def sharded_campaign_repeat(data, teach_grids, wps, n_wps, cfg: Config,
                            n_ticks: int, mesh=None):
    """The batched repeat campaign with the route axis split over ``mesh``
    (default: every CUDA card).  The shards step chunk by chunk together
    and stop together once every row of the padded batch is done, as one
    batched run would.  Returns the padded batch's RepeatResult: traces as
    numpy arrays, the final state on the first device."""
    from nclt_slam_tpu_torch.rollout.campaign import (
        CampaignData,
        apply_stock_projection,
        planned_chunks,
        run_campaign_repeat,
    )
    from nclt_slam_tpu_torch.rollout.repeat import RepeatResult

    mesh = list(mesh) if mesh is not None else route_mesh()
    n = len(mesh)
    wps, n_wps = apply_stock_projection(teach_grids, wps, n_wps, cfg)
    batch = pad_batch((data.scenes_repeat, data.routes, teach_grids, wps,
                       n_wps), n)
    shards = shard_over_routes(batch, mesh)
    views = [CampaignData(scenes_teach=sc, scenes_repeat=sc, routes=rt)
             for sc, rt, *_ in shards]
    _, chunk = planned_chunks(n_ticks, 250)   # run_campaign_repeat's
    carries = [None] * n
    # shards on one device take turns: their threads would only contend
    # for the interpreter lock at every one of the tick's small operations
    turns = {dev: threading.Lock() for dev in mesh}

    def step(i, t0):
        _, _, tg, wp, nw = shards[i]
        ctx = torch.cuda.device(mesh[i]) if mesh[i].type == "cuda" \
            else nullcontext()
        with turns[mesh[i]], ctx:
            return run_campaign_repeat(views[i], tg, wp, nw, cfg, chunk,
                                       chunk=chunk, carry=carries[i],
                                       tick0=t0, stop_when_done=False)

    traces = []
    with ThreadPoolExecutor(n) as pool:
        for t0 in range(0, n_ticks, chunk):
            results = list(pool.map(step, range(n), [t0] * n))
            carries = [r.final for r in results]
            traces.append(_zip_map(lambda xs: np.concatenate(xs, 0),
                                   [r.trace for r in results]))
            if all(bool(r.trace.done[:, -1].all()) for r in results):
                break
    trace = _zip_map(lambda xs: np.concatenate(xs, 1)[:, :n_ticks], traces)
    final = _zip_map(lambda xs: torch.cat([x.to(mesh[0]) for x in xs], 0),
                     carries)
    return RepeatResult(trace=trace, final=final)

