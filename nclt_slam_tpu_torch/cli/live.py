"""Live drive/observability server (``nclt_slam_tpu/cli/live.py``; the
reference web_nav.py's live half).

The reference serves a Flask app with an MJPEG camera feed, a 2-D map with
the robot trail, click-to-drive goals and STOP/reset controls
(simulation/isaac/tools/web_nav.py:1-503).  Here the repeat rollout runs in
short chunks on the CUDA card (or ``--device cpu``) and the carry is exposed
between chunks:

- 2-D map canvas: scene colliders + teach WPs + live GT/nav trails
- camera feed: the depth raycaster's current frame as a grayscale PNG
- click-to-drive: a map click replaces the dispatcher's waypoint list with
  the clicked goal, driven through the real planner + follower stack
- STOP/GO + "remove obstacles" (fires the turnaround supervisor's drop
  mask by hand, like the reference's /tmp flag file)

    python -m nclt_slam_tpu_torch.cli.live --route 03_south --port 8765

The rollout keeps a batch of one route.  The PNG is written with ``zlib``
(no imaging library); its 320x240 resize picks the source pixels that
``PIL.Image.NEAREST`` picks.
"""

from __future__ import annotations

import argparse
import binascii
import json
import struct
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from nclt_slam_tpu_torch.cli.common import add_device_arg, config_for
from nclt_slam_tpu_torch.dynamics.diffdrive import robot_pose3d
from nclt_slam_tpu_torch.landmarks.store import init_store
from nclt_slam_tpu_torch.rollout.campaign import (
    build_campaign,
    campaign_device,
    run_campaign_teach,
    teach_waypoints,
)
from nclt_slam_tpu_torch.rollout.repeat import init_repeat_carry, run_repeat
from nclt_slam_tpu_torch.sensors.depth import render_depth

PAGE = """<!DOCTYPE html>
<html><head><title>nclt_slam_tpu live</title>
<style>
 body { font-family: sans-serif; margin: 1.2em; background: #111; color: #eee; }
 canvas { border: 1px solid #444; background: #181818; cursor: crosshair; }
 img { border: 1px solid #444; image-rendering: pixelated; }
 button { margin: 0 4px; padding: 6px 14px; font-size: 14px; }
 #hud { font-family: monospace; white-space: pre; margin: 8px 0; }
</style></head>
<body>
<h3>nclt_slam_tpu — live drive</h3>
<div>
 <button onclick="post('/ctl',{cmd:'stop'})">STOP</button>
 <button onclick="post('/ctl',{cmd:'go'})">GO</button>
 <button onclick="post('/ctl',{cmd:'fire'})">remove obstacles</button>
 <span style="color:#888">click the map to drive there</span>
</div>
<div id="hud">connecting…</div>
<canvas id="cv" width="980" height="500"></canvas>
<img id="cam" width="320" height="240" src="/depth.png" style="vertical-align:top; margin-left:10px">
<script>
let scene = null, view = null;
const cv = document.getElementById('cv'), ctx = cv.getContext('2d');
function post(url, body) { fetch(url, {method:'POST', body: JSON.stringify(body)}); }
function w2c(p) { return [20+(p[0]-view[0])*view[4], cv.height-20-(p[1]-view[2])*view[4]]; }
cv.onclick = e => {
  if (!view) return;
  const r = cv.getBoundingClientRect();
  const x = (e.clientX-r.left-20)/view[4]+view[0];
  const y = (cv.height-20-(e.clientY-r.top))/view[4]+view[2];
  post('/goal', {x: x, y: y});
};
async function tick() {
  try {
    if (!scene) scene = await (await fetch('/scene.json')).json();
    const s = await (await fetch('/state.json')).json();
    const xs = scene.bounds;
    view = [xs[0], xs[1], xs[2], xs[3],
            Math.min((cv.width-40)/(xs[1]-xs[0]), (cv.height-40)/(xs[3]-xs[2]))];
    ctx.clearRect(0,0,cv.width,cv.height);
    for (const o of scene.obstacles) {
      const [cx, cy] = w2c(o); ctx.beginPath();
      ctx.fillStyle = o[3] ? (s.fired ? '#333' : '#a33') : '#555';
      ctx.arc(cx, cy, Math.max(2, o[2]*view[4]), 0, 7); ctx.fill();
    }
    ctx.fillStyle = '#3a3';
    for (const p of scene.wps) { const [cx,cy]=w2c(p); ctx.fillRect(cx-2,cy-2,4,4); }
    for (const [trail, color] of [[s.gt, '#58a6ff'], [s.nav, '#ffa657']]) {
      if (!trail.length) continue;
      ctx.beginPath(); ctx.strokeStyle = color; ctx.lineWidth = 1.5;
      ctx.moveTo(...w2c(trail[0]));
      for (const p of trail) ctx.lineTo(...w2c(p));
      ctx.stroke();
    }
    if (s.goal) { const [cx,cy]=w2c(s.goal); ctx.strokeStyle='#f5f'; ctx.lineWidth=2;
      ctx.beginPath(); ctx.arc(cx,cy,8,0,7); ctx.stroke(); }
    if (s.gt.length) { const [cx,cy]=w2c(s.gt[s.gt.length-1]);
      ctx.fillStyle='#fff'; ctx.beginPath(); ctx.arc(cx,cy,5,0,7); ctx.fill(); }
    document.getElementById('hud').textContent =
      `t=${(s.tick*0.1).toFixed(1)}s  wp ${s.wp_idx}/${s.n_wps}  drift=${s.drift.toFixed(2)}m` +
      `  regime=${['no_anchor','ok','strong','encoder','gt'][s.regime] ?? s.regime}` +
      `  v=${s.v.toFixed(2)}  ${s.running ? (s.paused ? 'PAUSED' : 'RUNNING') : 'DONE'}`;
    document.getElementById('cam').src = '/depth.png?' + s.tick;
  } catch (e) { document.getElementById('hud').textContent = 'server gone: '+e; }
  setTimeout(tick, 500);
}
tick();
</script></body></html>"""

PNG_SIZE = (320, 240)   # width, height of the camera feed


class LiveState:
    """Shared state between the rollout loop and the HTTP handlers."""

    def __init__(self):
        self.lock = threading.Lock()
        self.scene_blob = b"{}"
        self.state_blob = b"{}"
        self.depth_png = b""
        self.goal = None          # (x, y) pending click
        self.paused = False
        self.fire = False


def _handler(live: LiveState):
    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, blob, ctype="application/json"):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def do_GET(self):
            if self.path == "/":
                self._send(PAGE.encode(), "text/html")
            elif self.path == "/scene.json":
                self._send(live.scene_blob)
            elif self.path == "/state.json":
                self._send(live.state_blob)
            elif self.path.startswith("/depth.png"):
                self._send(live.depth_png or b"", "image/png")
            else:
                self.send_error(404)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            with live.lock:
                if self.path == "/goal":
                    live.goal = (float(body["x"]), float(body["y"]))
                elif self.path == "/ctl":
                    cmd = body.get("cmd")
                    if cmd == "stop":
                        live.paused = True
                    elif cmd == "go":
                        live.paused = False
                    elif cmd == "fire":
                        live.fire = True
            self._send(b"{}")

    return H


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """Source index of each output pixel of a nearest-neighbour resize: the
    pixel under the output pixel's centre, its coordinate accumulated in
    float64 steps as Pillow's NEAREST scaling accumulates it (so a centre
    that falls on a pixel edge rounds as Pillow's does)."""
    step = n_in / n_out
    pos = step * 0.5
    idx = []
    for _ in range(n_out):
        idx.append(min(int(pos), n_in - 1))
        pos += step
    return np.asarray(idx, np.int64)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", binascii.crc32(tag + data) & 0xFFFFFFFF))


def _gray_png(img: np.ndarray) -> bytes:
    """An 8-bit grayscale PNG of ``img`` (H, W) uint8, unfiltered rows."""
    h, w = img.shape
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0,
                                              0))
            + _png_chunk(b"IDAT", zlib.compress(raw, 6))
            + _png_chunk(b"IEND", b""))


def _depth_png(depth, dvalid, cfg):
    """Depth frame (rows, cols) -> grayscale PNG bytes (near bright, far
    dark), resized to 320x240."""
    d = np.asarray(depth, np.float32)
    v = np.asarray(dvalid)
    g = np.where(v, 1.0 - np.clip(d / cfg.camera.depth_max, 0, 1), 0.0)
    img = (g * 255).astype(np.uint8)
    w, h = PNG_SIZE
    img = img[_nearest_index(img.shape[0], h)][:, _nearest_index(
        img.shape[1], w)]
    return _gray_png(np.ascontiguousarray(img))


def inject_goal(carry, goal_xy, cfg):
    """Click-to-drive: replace the dispatcher's remaining waypoint list of
    the carry's one route with the clicked goal (the reference writes
    /tmp/isaac_goal.txt and its dispatcher retargets; here the real hybrid
    dispatcher retargets)."""
    d = carry.dispatch
    B, W = d.wps.shape[:2]
    dev = d.wps.device
    goal = torch.tensor(goal_xy, dtype=torch.float32, device=dev)
    g = goal.expand(B, W, 2).clone()
    zi = torch.zeros(B, dtype=torch.int32, device=dev)
    d = d._replace(
        wps=g, wps_proj=g.clone(), n_wps=zi + 1, idx=zi.clone(),
        target=goal.expand(B, 2).clone(),
        skip=torch.zeros(B, W, dtype=torch.bool, device=dev),
        ticks_on_wp=zi.clone(), plan_fails=zi.clone(),
        done=torch.zeros(B, dtype=torch.bool, device=dev),
        reached_count=zi.clone(), skipped_count=zi.clone())
    return carry._replace(dispatch=d)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--route", default="03_south")
    ap.add_argument("--mode", default="ours")
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address; set 0.0.0.0 to expose the control "
                         "endpoints beyond this machine")
    ap.add_argument("--ticks", type=int, default=12000)
    ap.add_argument("--chunk", type=int, default=50)
    ap.add_argument("--teach-ticks", type=int, default=9000)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--obstacles", action="store_true", default=True)
    ap.add_argument("--no-obstacles", dest="obstacles", action="store_false")
    add_device_arg(ap)
    ap.add_argument("--max-chunks", type=int, default=None,
                    help="(testing) stop after N chunks")
    args = ap.parse_args(argv)

    dev = campaign_device(args.device)
    cfg = config_for(args.mode, args.scale)
    cfg_teach = config_for("gt", args.scale)

    live = LiveState()
    srv = ThreadingHTTPServer((args.host, args.port), _handler(live))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    print(f"[live] http://{args.host}:{args.port}  route={args.route} "
          f"mode={args.mode} device={dev}", flush=True)
    try:
        _drive(args, live, dev, cfg, cfg_teach)
        print("[live] rollout finished; server stays up (ctrl-c to exit)",
              flush=True)
        if not args.max_chunks:
            threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        srv.shutdown()
        srv.server_close()
    return 0


def _drive(args, live: LiveState, dev, cfg, cfg_teach):
    """Teach, then the chunked repeat loop that serves the carry."""
    data = build_campaign([args.route], cfg=cfg, with_drops=args.obstacles,
                          device=dev)
    print("[live] teaching…", flush=True)
    teach = run_campaign_teach(data, cfg_teach, args.teach_ticks)
    wps, n_wps = teach_waypoints(data, teach, cfg_teach)

    sc, rt, grid = data.scenes_repeat, data.routes, teach.teach_grid
    store = teach.store if args.mode != "gt" \
        else init_store(cfg.landmarks, 1, dev)
    n0 = int(n_wps[0])

    # scene blob (once)
    obs = [[float(x), float(y), float(r), int(dm)]
           for (x, y), r, v, dm in zip(
               sc.xy[0].cpu().numpy(), sc.radius[0].cpu().numpy(),
               sc.valid[0].cpu().numpy(), sc.drop_mask[0].cpu().numpy())
           if v]
    wp_list = wps[0, :n0].cpu().numpy().tolist()
    pts = np.asarray([o[:2] for o in obs] + wp_list)
    bounds = [float(pts[:, 0].min() - 5), float(pts[:, 0].max() + 5),
              float(pts[:, 1].min() - 5), float(pts[:, 1].max() + 5)]
    live.scene_blob = json.dumps(
        {"obstacles": obs, "wps": wp_list, "bounds": bounds}).encode()

    carry = init_repeat_carry(rt, wps, n_wps, cfg)
    gt_trail, nav_trail = [], []
    tick0 = 0
    chunks = 0
    goal = None
    print("[live] driving (chunked)…", flush=True)
    while tick0 < args.ticks:
        with live.lock:
            paused = live.paused
            if live.goal is not None:
                goal = live.goal
                live.goal = None
                carry = inject_goal(carry, goal, cfg)
            if live.fire:
                live.fire = False
                carry = carry._replace(sup=carry.sup._replace(
                    fired=torch.ones_like(carry.sup.fired)))
        if paused:
            # surface the parked state so clients (and the stop test) can
            # tell "parked between chunks" from "chunk in flight"
            with live.lock:
                st = json.loads(live.state_blob)
                if not st.get("paused"):
                    st["paused"] = True
                    live.state_blob = json.dumps(st).encode()
            time.sleep(0.3)
            continue

        res = run_repeat(sc, rt, grid, wps, n_wps, cfg, args.chunk,
                         store=store, carry=carry, tick0=tick0)
        carry = res.final
        tick0 += args.chunk
        chunks += 1

        tr = res.trace
        gt = tr.gt_xy[0].cpu().numpy()
        nav = tr.nav_xy[0].cpu().numpy()
        gt_trail.extend(gt[::5].tolist())
        nav_trail.extend(nav[::5].tolist())
        pos3, _ = robot_pose3d(carry.robot)
        valid_now = sc.valid & ~(sc.drop_mask & carry.sup.fired[:, None])
        depth, _, dvalid = render_depth(pos3, carry.robot.yaw, sc.xy,
                                        sc.radius, sc.base_z, sc.height,
                                        valid_now, cfg.camera)
        live.depth_png = _depth_png(depth[0].cpu().numpy(),
                                    dvalid[0].cpu().numpy(), cfg)
        regime = int(tr.regime[0, -1])
        state = {
            "tick": tick0,
            "gt": gt_trail[-2000:], "nav": nav_trail[-2000:],
            "wp_idx": int(tr.wp_idx[0, -1]), "n_wps": n0,
            "drift": float(np.hypot(*(nav[-1] - gt[-1]))),
            "regime": regime if regime >= 0 else 4,
            "v": float(tr.cmd_v[0, -1]),
            "fired": bool(tr.fired[0, -1]),
            "goal": list(goal) if goal else None,
            "running": True, "paused": False,
        }
        live.state_blob = json.dumps(state).encode()
        if bool(tr.done[0, -1]) and goal is None:
            print("[live] route complete", flush=True)
            break
        if args.max_chunks and chunks >= args.max_chunks:
            break

    state = json.loads(live.state_blob or b"{}")
    state["running"] = False
    live.state_blob = json.dumps(state).encode()


if __name__ == "__main__":
    raise SystemExit(main())
