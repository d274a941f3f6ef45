"""The port's live drive server (``nclt_slam_tpu_torch/cli/live.py``):
the JAX test's three behaviours (``tests/test_live.py``: the endpoints
serve, click-to-drive retargets the real dispatcher, STOP parks the tick)
against the port's server in a subprocess on the CPU; ``inject_goal`` on a
carry carried from JAX; and the camera PNG's decoded pixels against the
JAX CLI's Pillow-written PNG.
"""

import io
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from nclt_slam_tpu import config as jcfg_mod
from nclt_slam_tpu.cli import live as jlive
from nclt_slam_tpu.rollout import campaign as jcamp
from nclt_slam_tpu.rollout.repeat import init_repeat_carry as j_init_carry
from nclt_slam_tpu_torch import config as tcfg_mod
from nclt_slam_tpu_torch import interop
from nclt_slam_tpu_torch.cli import live as tlive

ROOT = Path(__file__).resolve().parent.parent
DEADLINE_S = 600     # the server process is killed at this age


def free_port() -> int:
    """A port other than ``tests/test_live.py``'s 8991, free right now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Client:
    def __init__(self, port):
        self.base = f"http://127.0.0.1:{port}"

    def get(self, path, timeout=5):
        with urllib.request.urlopen(self.base + path, timeout=timeout) as r:
            return r.read()

    def state(self):
        return json.loads(self.get("/state.json"))

    def post(self, path, body):
        req = urllib.request.Request(self.base + path,
                                     data=json.dumps(body).encode(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.read()


@pytest.fixture(scope="module")
def live_server():
    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "nclt_slam_tpu_torch.cli.live",
         "--route", "09_se_ne", "--mode", "gt", "--port", str(port),
         "--scale", "0.25", "--teach-ticks", "300", "--ticks", "2000",
         "--chunk", "25", "--max-chunks", "40", "--device", "cpu"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    born = time.time()
    killer = threading.Timer(DEADLINE_S, proc.kill)
    killer.start()
    client = Client(port)
    state = None
    try:
        while time.time() < born + 300:
            if proc.poll() is not None:
                out = proc.stdout.read().decode()
                raise RuntimeError(f"live server died:\n{out[-3000:]}")
            try:
                state = client.state()
                if state.get("tick", 0) >= 25:
                    break
            except OSError:
                pass
            time.sleep(1)
        assert state and state.get("tick", 0) >= 25, "no first chunk in time"
        yield client
    finally:
        killer.cancel()
        proc.kill()
        proc.wait(timeout=30)


def test_live_endpoints(live_server):
    page = live_server.get("/").decode()
    assert "live drive" in page
    scene = json.loads(live_server.get("/scene.json"))
    assert scene["obstacles"] and scene["wps"] and len(scene["bounds"]) == 4
    png = live_server.get("/depth.png")
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert Image.open(io.BytesIO(png)).size == (320, 240)
    state = live_server.state()
    assert state["gt"] and state["n_wps"] > 0


def test_live_click_to_drive(live_server):
    """POST /goal retargets the dispatcher; the robot converges on it."""
    x0, y0 = live_server.state()["gt"][-1]
    goal = {"x": x0 + 6.0, "y": y0 + 4.0}
    live_server.post("/goal", goal)
    deadline = time.time() + 200
    best = 1e9
    while time.time() < deadline:
        s = live_server.state()
        if s.get("goal"):
            gx, gy = s["gt"][-1]
            best = min(best, np.hypot(gx - goal["x"], gy - goal["y"]))
            if best < 3.5 or not s.get("running", True):
                break
        time.sleep(1)
    assert best < 3.5, f"never approached clicked goal (best {best:.1f} m)"


def test_live_stop_pauses(live_server):
    live_server.post("/ctl", {"cmd": "stop"})
    # state.json says "paused" only once the drive loop has parked between
    # chunks; from then on the tick must hold still
    deadline = time.time() + 120
    s = live_server.state()
    while time.time() < deadline:
        s = live_server.state()
        if s.get("paused") or not s.get("running", True):
            break
        time.sleep(1)
    assert s.get("paused") or not s.get("running", True), \
        "server never parked after STOP"
    t1 = s["tick"]
    time.sleep(3)
    t3 = live_server.state()["tick"]
    live_server.post("/ctl", {"cmd": "go"})
    assert t3 == t1, "ticks kept advancing while STOPped"


def test_inject_goal_matches_jax():
    cfg = jcfg_mod.ours()
    data = jcamp.build_campaign(["03_south"], cfg=cfg)
    rt = jax.tree_util.tree_map(lambda x: x[0], data.routes)
    carry = j_init_carry(rt, rt.wps, rt.n_wps, cfg)
    goal = (12.5, -3.25)
    jnew = jlive.inject_goal(carry, goal, cfg)
    batch = jax.tree_util.tree_map(lambda x: np.asarray(x)[None], carry)
    tnew = tlive.inject_goal(interop.from_numpy_tree(batch, "cpu"), goal,
                             tcfg_mod.ours())
    for name in jnew.dispatch._fields:
        a = np.asarray(getattr(jnew.dispatch, name))
        b = interop.to_numpy_tree(getattr(tnew.dispatch, name))[0]
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert tnew.robot.xy.shape == (1, 2)
    assert torch.equal(tnew.robot.xy,
                       torch.from_numpy(np.array(carry.robot.xy))[None])


@pytest.mark.parametrize("shape", [(60, 80), (15, 20), (32, 47), (240, 320)])
def test_depth_png_pixels_match_jax(shape):
    rng = np.random.RandomState(sum(shape))
    depth = rng.uniform(0, 15, shape).astype(np.float32)
    valid = rng.rand(*shape) < 0.8
    jpng = jlive._depth_png(depth, valid, jcfg_mod.ours())
    tpng = tlive._depth_png(depth, valid, tcfg_mod.ours())
    a = np.asarray(Image.open(io.BytesIO(jpng)))
    b = np.asarray(Image.open(io.BytesIO(tpng)))
    assert Image.open(io.BytesIO(tpng)).mode == "L"
    assert b.shape == (240, 320)
    assert np.array_equal(a, b)
