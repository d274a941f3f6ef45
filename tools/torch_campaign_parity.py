#!/usr/bin/env python3
"""Campaign parity of the PyTorch port: its 15-route calibration tables
(``tools/torch_calibrate.py --routes all --teach-ticks 12000 --ticks
12000``, one teach for every mode) held against the JAX package's r5
tables by bands fixed before the port's first full-length run.

Rollouts are chaotic and a campaign has 15 routes, so a route near its
tolerance may flip between two implementations of the same model (the
JAX package's own r4 -> r5 change moved ours' reach by 1 and its return
by 2); the bands (``BANDS``) bound what such flips can move:

- B1 reach / return count: each within ``count`` of JAX's (ours, rgbd,
  stock; stock's executed repeat ticks printed beside it, unbanded);
- B2 per-route flags: ``reached_final`` and ``returned_spawn`` each agree
  on at least ``agree`` routes;
- B3 coverage: ``avg_coverage_pct`` within ``points``;
- B4 drift: ``avg_drift_mean`` within max(``rel`` x JAX's, ``floor_m``);
- B5 anchor funnel (ours, rgbd): each outcome's attempt-weighted share
  within ``points``, the live attempts within ``rel`` of JAX's;
- B6 teach drift (the shared teach): the route mean of the per-route mean
  drift within ``rel`` of JAX's, every route's mean under ``route_max_m``
  (the r5 bound).

The encoder table is reported beside them with no band: the JAX
package's ``encoder.json`` predates its r5 teach.  Where the port's
directory holds ``divergence.json`` (``tools/torch_divergence_probe.py
--summary``), each missed band carries the probes of its mode (the route,
the phase, the probe's verdict and the stages that decide the band,
``DECIDING``, that its checks ran) and a verdict of its own: "fault" when
a probe found a stage that differs on JAX's inputs, "chaos" when every
probe's checks held and ran every deciding stage, "unresolved" when a
deciding stage was never checked or no probe of the mode exists.

    python3 tools/torch_campaign_parity.py \\
        [--port-dir artifacts/calibration_torch] \\
        [--ref-dir artifacts/calibration] \\
        [--out artifacts/calibration_torch/parity.json]

Prints every band's value, limit and verdict; exits 0 whether or not a
band is missed (the verdicts are the result; 2 when a table is missing).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

BANDED = ("ours", "rgbd", "stock")
UNBANDED = ("encoder",)
OUTCOMES = ("published", "no_pnp_accept", "no_candidates",
            "consistency_fail", "no_features")

# tools/torch_divergence_probe.py --summary: where routes leave JAX on the
# CPU, attached to the missed bands of their mode
EVIDENCE = "divergence.json"

# The stages of the repeat tick (the teach tick for B6) that decide each
# band's quantity, as tools/torch_divergence_probe.py names them: a chaos
# verdict stands only on checks that ran them.
NAV = ("costmap_window", "dispatch_plan", "dispatch_move", "follower")
DECIDING = {"B1": NAV, "B2": NAV, "B3": NAV,
            "B4": ("vio_frame", "fusion_tick"),
            "B5": ("match_tick", "anchor_update"),
            "B6": ("chase_cmd", "vio_frame")}

# Fixed before the port's first full-length card run; never moved after.
BANDS = {
    "B1": {"modes": BANDED, "count": 2},
    "B2": {"modes": BANDED, "agree": 12},
    "B3": {"modes": BANDED, "points": 6.0},
    "B4": {"modes": BANDED, "rel": 0.25, "floor_m": 0.5},
    "B5": {"modes": ("ours", "rgbd"), "points": 5.0, "rel": 0.20},
    "B6": {"rel": 0.30, "route_max_m": 1.2},
}


def row(band, mode, quantity, port, jax, limit, held, **extra):
    return {"band": band, "mode": mode, "quantity": quantity, "port": port,
            "jax": jax, "limit": limit, "held": bool(held), **extra}


def funnel(anchor: dict) -> tuple[int, dict]:
    """Live attempts over all routes and each outcome's share of them,
    every route weighted by its attempts (``torch_calibrate.report``)."""
    total = sum(a["attempts"] for a in anchor.values())
    share = {k: sum(a["frac"].get(k, 0.0) * a["attempts"]
                    for a in anchor.values()) / max(total, 1)
             for k in OUTCOMES}
    return total, share


def flags(table: dict, key: str) -> dict:
    return {n: bool(m[key]) for n, m in table["per_route"].items()}


def mode_bands(mode: str, port: dict, jax: dict) -> list:
    rows = []
    pa, ja = port["agg"], jax["agg"]
    b = BANDS["B1"]
    for key in ("reach", "return"):
        extra = {}
        if mode == "stock" and key == "reach":
            extra["repeat_ticks_executed"] = \
                port.get("ticks_executed", {}).get("repeat")
        rows.append(row("B1", mode, key, pa[key], ja[key],
                        f"|port - jax| <= {b['count']}",
                        abs(pa[key] - ja[key]) <= b["count"], **extra))
    b = BANDS["B2"]
    for key in ("reached_final", "returned_spawn"):
        fp, fj = flags(port, key), flags(jax, key)
        if set(fp) != set(fj):
            raise SystemExit(f"{mode}: the tables name different routes")
        agree = sum(fp[n] == fj[n] for n in fj)
        rows.append(row("B2", mode, f"{key} agreeing routes", agree,
                        len(fj), f">= {b['agree']} of {len(fj)}",
                        agree >= b["agree"],
                        flipped=[n for n in fj if fp[n] != fj[n]],
                        port_flags="".join("R" if fp[n] else "." for n in fj),
                        jax_flags="".join("R" if fj[n] else "." for n in fj)))
    b = BANDS["B3"]
    d = pa["avg_coverage_pct"] - ja["avg_coverage_pct"]
    rows.append(row("B3", mode, "avg_coverage_pct", pa["avg_coverage_pct"],
                    ja["avg_coverage_pct"], f"|delta| <= {b['points']}",
                    abs(d) <= b["points"], delta=d))
    b = BANDS["B4"]
    lim = max(b["rel"] * ja["avg_drift_mean"], b["floor_m"])
    d = pa["avg_drift_mean"] - ja["avg_drift_mean"]
    rows.append(row("B4", mode, "avg_drift_mean", pa["avg_drift_mean"],
                    ja["avg_drift_mean"], f"|delta| <= {lim:.4f} m",
                    abs(d) <= lim, delta=d))
    if mode in BANDS["B5"]["modes"]:
        b = BANDS["B5"]
        tp, sp = funnel(port["anchor"])
        tj, sj = funnel(jax["anchor"])
        for k in OUTCOMES:
            d = (sp[k] - sj[k]) * 100
            rows.append(row("B5", mode, f"{k} %", sp[k] * 100, sj[k] * 100,
                            f"|delta| <= {b['points']} points",
                            abs(d) <= b["points"], delta=d))
        rows.append(row("B5", mode, "attempts", tp, tj,
                        f"within {b['rel']:.0%} of jax",
                        abs(tp - tj) <= b["rel"] * tj))
    return rows


def teach_bands(port: dict, jax: dict) -> list:
    """B6 on the shared teach (each port table must carry the same one)."""
    b = BANDS["B6"]
    tp, tj = port["teach_drift"], jax["teach_drift"]
    mp = sum(v[0] for v in tp.values()) / len(tp)
    mj = sum(v[0] for v in tj.values()) / len(tj)
    worst = max(tp, key=lambda n: tp[n][0])
    return [row("B6", "teach", "route mean of mean drift [m]", mp, mj,
                f"within {b['rel']:.0%} of jax",
                abs(mp - mj) <= b["rel"] * mj),
            row("B6", "teach", "largest route mean drift [m]", tp[worst][0],
                max(v[0] for v in tj.values()), f"< {b['route_max_m']} m",
                tp[worst][0] < b["route_max_m"], route=worst)]


def check(port_dir: Path, ref_dir: Path) -> dict:
    port = {m: json.loads((port_dir / f"{m}.json").read_text())
            for m in BANDED}
    jax = {m: json.loads((ref_dir / f"{m}.json").read_text())
           for m in BANDED}
    teaches = {m: t["teach_drift"] for m, t in port.items()}
    if any(t != teaches[BANDED[0]] for t in teaches.values()):
        raise SystemExit("the port's tables come from different teaches")
    rows = teach_bands(port[BANDED[0]], jax[BANDED[0]])
    for m in BANDED:
        rows += mode_bands(m, port[m], jax[m])
    unbanded = {}
    for m in UNBANDED:
        p = port_dir / f"{m}.json"
        if p.is_file():
            t = json.loads(p.read_text())
            unbanded[m] = {"agg": t["agg"],
                           "ticks_executed": t.get("ticks_executed")}
    missed = sorted({r["band"] for r in rows if not r["held"]})
    res = {"bands": rows, "held": not missed, "missed_bands": missed,
           "limits": BANDS, "unbanded": unbanded}
    ev = port_dir / EVIDENCE
    probes = json.loads(ev.read_text())["probes"] if ev.is_file() else []
    if probes:
        res["evidence"] = probes
    for r in rows:
        if not r["held"]:
            r["evidence"], r["verdict"] = band_evidence(r, probes)
    return res


def band_evidence(r: dict, probes: list) -> tuple[list, str]:
    """The probes of a missed band's mode, each with the band's deciding
    stages its checks ran and missed, and the band's verdict."""
    phase = "teach" if r["mode"] == "teach" else "repeat"
    deciding = DECIDING[r["band"]]
    ev = []
    for p in probes:
        if (p["mode"] if phase == "repeat" else "teach") != r["mode"] or \
                phase not in p:
            continue
        ran = set(p[phase].get("stages_checked", ()))
        ev.append({"route": p["route"], "mode": p["mode"],
                   "phase": p["phase"], "verdict": p["verdict"],
                   "deciding_stages": list(deciding),
                   "deciding_unchecked": [s for s in deciding
                                          if s not in ran]})
    if any(e["verdict"] == "fault" for e in ev):
        return ev, "fault"
    if ev and all(e["verdict"] == "chaos" and not e["deciding_unchecked"]
                  for e in ev):
        return ev, "chaos"
    return ev, "unresolved"


def print_report(res: dict) -> None:
    print("=== campaign parity: port against the JAX r5 tables ===")
    for r in res["bands"]:
        port, jax = r["port"], r["jax"]
        fmt = (lambda v: f"{v:.4f}") if isinstance(port, float) else str
        verdict = "held" if r["held"] else f"MISSED ({r['verdict']})"
        print(f"{r['band']} {r['mode']:<6} {r['quantity']:<34} "
              f"port {fmt(port):>10}  jax {fmt(jax):>10}  "
              f"{r['limit']:<26} {verdict}")
    for m, t in res["unbanded"].items():
        print(f"(no band) {m}: {json.dumps(t['agg'])}")
    for p in res.get("evidence", []):
        rep = p.get("repeat") or p.get("teach")
        part = rep.get("parting") or {}
        print(f"(probe) {p['route']} {p['mode']} {p['phase']}: first GT "
              f"parting at tick {part.get('tick')}, "
              f"{len(rep.get('checks', []))} ticks checked (stages "
              f"{', '.join(rep.get('stages_checked', []))}): {p['verdict']}")
    print(f"missed bands: {res['missed_bands'] or 'none'}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port-dir", type=Path,
                    default=REPO / "artifacts" / "calibration_torch")
    ap.add_argument("--ref-dir", type=Path,
                    default=REPO / "artifacts" / "calibration")
    ap.add_argument("--out", type=Path, default=None,
                    help="parity.json (default: in --port-dir)")
    args = ap.parse_args(argv)
    missing = [str(d / f"{m}.json") for d in (args.port_dir, args.ref_dir)
               for m in BANDED if not (d / f"{m}.json").is_file()]
    if missing:
        print(f"missing tables: {missing}", file=sys.stderr)
        return 2
    res = check(args.port_dir, args.ref_dir)
    print_report(res)
    out = args.out or args.port_dir / "parity.json"
    out.write_text(json.dumps(res, indent=1) + "\n")
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
