"""State carried across between the JAX package and the port.

``from_numpy_tree`` turns a tree of the JAX package's state — packed
scenes and routes, teach and repeat carries, traces, results, PRNG keys,
the SLAM path's pose graphs, local maps and ICP / registration results,
the place-recognition model's parameters and mined pairs —
into the port's NamedTuples of tensors, matched by type and field name;
``to_numpy_tree`` turns the port's state back into numpy.  The leaves are
numpy arrays (or anything ``np.asarray`` takes, such as a JAX array), so
this module itself imports nothing of JAX.

uint32 data (PRNG keys, descriptors) lives in the port as int64 tensors
holding values in [0, 2**32); every other dtype is kept.  The port's
tensors carry a leading route dimension, so a JAX carry is converted as a
route batch (the output of a ``jax.vmap``ed initializer, for instance).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=1)
def _registry() -> dict:
    from nclt_slam_tpu_torch.control import pure_pursuit, rpp, supervisor
    from nclt_slam_tpu_torch.datasets import pairs
    from nclt_slam_tpu_torch.datasets.models import place_recognition
    from nclt_slam_tpu_torch.datasets.slam import icp, loop_closure, registration
    from nclt_slam_tpu_torch.dynamics import diffdrive
    from nclt_slam_tpu_torch.fusion import relay
    from nclt_slam_tpu_torch.landmarks import matcher, store
    from nclt_slam_tpu_torch.planning import dispatcher, wavefront
    from nclt_slam_tpu_torch.rollout import campaign, repeat, scene_pack, teach
    from nclt_slam_tpu_torch.sensors import features, imu
    from nclt_slam_tpu_torch.vio import ba, drift_monitor, preintegration, tracker

    types = [
        pure_pursuit.CtrlState, rpp.RppState, supervisor.SupervisorState,
        diffdrive.RobotState, relay.FusionState, store.LandmarkStore,
        dispatcher.DispatchState, wavefront.PlanResult,
        scene_pack.PackedScene, scene_pack.PackedRoute,
        teach.TeachCarry, teach.TeachTrace, teach.TeachResult,
        repeat.RepeatCarry, repeat.RepeatTrace, repeat.RepeatResult,
        features.Observation, features.SceneFeatures, imu.ImuState,
        drift_monitor.DriftMonitorState, tracker.VioState, tracker.VioAux,
        preintegration.Preintegrated, matcher.AnchorResult,
        campaign.CampaignData, ba.BAProblem, ba.BAResult,
        loop_closure.PoseGraph2D, icp.ICPResult, icp.LocalMap,
        registration.RegistrationResult,
        place_recognition.PRParams, pairs.MinedPairs,
    ]
    return {t.__name__: t for t in types}


def _leaf_to_tensor(x, device):
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    elif a.dtype.kind not in "biuf":
        raise TypeError(f"cannot carry a {a.dtype} leaf into the port")
    return torch.from_numpy(np.array(a, order="C")).to(device)


def from_numpy_tree(tree, device):
    """JAX-package state (numpy/JAX leaves) -> the port's tensors."""
    if tree is None or isinstance(tree, (str, bool, int, float)):
        return tree
    name = type(tree).__name__
    if hasattr(tree, "_fields"):
        cls = _registry().get(name)
        if cls is None:
            raise TypeError(f"no port counterpart for {name}")
        if tuple(cls._fields) != tuple(tree._fields):
            raise TypeError(f"{name}: fields differ from the port's")
        return cls(*(from_numpy_tree(v, device) for v in tree))
    if dataclasses.is_dataclass(tree):
        cls = _registry()[name]
        return cls(**{f.name: from_numpy_tree(getattr(tree, f.name), device)
                      for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        return type(tree)(from_numpy_tree(v, device) for v in tree)
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device) for k, v in tree.items()}
    return _leaf_to_tensor(tree, device)


def to_numpy_tree(tree):
    """The port's state -> the same types with numpy leaves; int64 leaves
    (uint32 data) come back as uint32."""
    if tree is None or isinstance(tree, (str, bool, int, float)):
        return tree
    if hasattr(tree, "_fields"):
        return type(tree)(*(to_numpy_tree(v) for v in tree))
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: to_numpy_tree(getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy_tree(v) for v in tree)
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    a = tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) \
        else np.asarray(tree)
    if a.dtype == np.int64:
        if a.size and (a.min() < 0 or a.max() > 0xFFFFFFFF):
            raise ValueError("int64 leaf outside the uint32 range")
        a = a.astype(np.uint32)
    return a
