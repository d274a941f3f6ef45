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
package's ``encoder.json`` predates its r5 teach.

Where the port's directory holds ``seeds/MODE.json`` (``tools/
torch_calibrate.py --seeds 1-8``: a table a seed off the same teach), the
``spread`` section holds JAX's figures against the port's own spread over
its K seeds, by a test fixed before the first seed run (``SPREAD``):

- a scalar quantity of B1-B5 (reach, return, coverage, drift, each B5
  share, attempts) is within spread when JAX's value lies in m +- t(0.995,
  K-1) s sqrt(1 + 1/K), the two-sided 99 % prediction interval of one
  new draw from the seeds' mean m and standard deviation s (s = 0: only m
  itself);
- a per-route flag (``reached_final``, ``returned_spawn``) is within spread
  when at most ``max_unseen`` routes are unseen: no seed shows JAX's flag
  there (each route's share of seeds with the flag set is printed).

A missed band whose quantities are all within spread is "chaos"; one with
a quantity outside is "outside" until the divergence probe has run its
mode at the routes that put it outside (B2: the unseen routes; B1, B3-B5:
the route whose JAX value lies furthest outside the route's own seed
range), then "fault" when a probe found a stage that differs on JAX's
inputs, "unresolved" when they all held.  Held bands with a quantity
outside spread are listed too.  ``witness`` compares each seed file's
seed-1 table with the mode's committed single-seed table: "equal", or the
first route and field that differ.  ``--adopt-seed1 MODE`` replaces the
mode's committed table by its seed file's seed-1 table (that seed's own
executed ticks, the batch's timings) before the check.  Where the port's
directory holds ``divergence.json`` (``tools/torch_divergence_probe.py
--summary``), each missed band carries the probes of its mode (the route,
the phase, the probe's verdict and the stages that decide the band,
``DECIDING``, that its checks ran) and a verdict of its own: "fault" when
a probe found a stage that differs on JAX's inputs, "chaos" when every
probe's checks held and ran every deciding stage, "unresolved" when a
deciding stage was never checked or no probe of the mode exists.

``--ref-cpu DIR`` (``tools/torch_jax_reference_probe.py``'s ``MODE.json``,
JAX's seed tables on the CPU off the port's own teach at a few routes,
and the port's seed files at the same routes, ``port_seeds*.json``) adds
the ``cpu_reference`` section: per route the port's card ``drift_mean``
over its seeds (P_r), JAX's CPU one over its seeds (J_r) and the TPU
table's, and the route rule (``route_rule``, fixed before the first
such run): r is systematic when min J_r > max P_r or max J_r < min P_r;
the mode is "fault" when 2 or more routes are systematic in the same
direction, or when at ``REACH_ROUTE`` every JAX seed misses
``reached_final`` while every port seed reaches it (or the reverse);
"platform" when no route is systematic and the TPU's value lies outside
the range of P_r and J_r together on 2 or more routes; "chaos"
otherwise.  For each band outside the port's spread it lists, at those
routes, where JAX's CPU runs lie beside the port's seeds and the TPU.

    python3 tools/torch_campaign_parity.py \\
        [--port-dir artifacts/calibration_torch] \\
        [--ref-dir artifacts/calibration] \\
        [--ref-cpu artifacts/calibration_torch/jax_cpu] \\
        [--out artifacts/calibration_torch/parity.json] [--adopt-seed1 ours]

Prints every band's value, limit and verdict; exits 0 whether or not a
band is missed (the verdicts are the result; 2 when a table is missing).
"""

from __future__ import annotations

import argparse
import json
import math
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


# The spread test over the port's seed tables: fixed before the first
# seed run, never moved after.
SEED_DIR = "seeds"
SPREAD = {"level": 0.99, "max_unseen": 2}
# t(0.995, df), Student's t two-sided 99 % quantile (scipy.stats.t.ppf)
T995 = {1: 63.656741, 2: 9.924843, 3: 5.840909, 4: 4.604095, 5: 4.032143,
        6: 3.707428, 7: 3.499483, 8: 3.355387, 9: 3.249836, 10: 3.169273,
        11: 3.105807, 12: 3.05454, 13: 3.012276, 14: 2.976843,
        15: 2.946713}
# B1's counts and the per-route flags they count (B2's quantities)
FLAGS = {"reach": "reached_final", "return": "returned_spawn"}

# The route rule against JAX's own CPU runs (--ref-cpu): fixed before the
# first such run, never moved after.
ROUTE_RULE = {"quantity": "drift_mean", "same_direction": 2,
              "tpu_outside": 2, "reach_route": "08_nw_sw"}
REACH_ROUTE = ROUTE_RULE["reach_route"]


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


def prediction_interval(values) -> tuple[float, float, list]:
    """(mean, standard deviation, [lo, hi]) of the two-sided 99 %
    prediction interval for one new draw from ``values`` (K >= 2)."""
    k = len(values)
    m = sum(values) / k
    sd = math.sqrt(sum((v - m) ** 2 for v in values) / (k - 1))
    if sd == 0.0:
        return values[0], 0.0, [values[0], values[0]]
    h = T995[k - 1] * sd * math.sqrt(1.0 + 1.0 / k)
    return m, sd, [m - h, m + h]


def scalar_quantities(table: dict, band: str) -> dict:
    """Band -> {quantity: (campaign value, {route: the route's value})}."""
    pr = table["per_route"]
    if band == "B1":
        return {k: (table["agg"][k], {n: float(m[f]) for n, m in pr.items()})
                for k, f in FLAGS.items()}
    if band == "B3":
        return {"avg_coverage_pct": (table["agg"]["avg_coverage_pct"],
                                     {n: m["cov_pct"] for n, m in pr.items()})}
    if band == "B4":
        return {"avg_drift_mean": (table["agg"]["avg_drift_mean"],
                                   {n: m["drift_mean"]
                                    for n, m in pr.items()})}
    if band == "B5":
        total, share = funnel(table["anchor"])
        out = {f"{k} %": (share[k] * 100,
                          {n: a["frac"].get(k, 0.0) * 100
                           for n, a in table["anchor"].items()})
               for k in OUTCOMES}
        out["attempts"] = (total, {n: a["attempts"]
                                   for n, a in table["anchor"].items()})
        return out
    return {}


def furthest_route(jax_routes: dict, seed_routes: list) -> str:
    """The route whose JAX value lies furthest outside the route's own seed
    range (ties: furthest from the seeds' mean)."""
    def key(n):
        vals = [r[n] for r in seed_routes if r[n] is not None]
        v = jax_routes[n]
        if v is None or not vals:
            return (-1.0, -1.0)
        lo, hi = min(vals), max(vals)
        return (max(lo - v, v - hi, 0.0), abs(v - sum(vals) / len(vals)))
    return max(jax_routes, key=key)


def mode_spread(mode: str, tables: list, jax: dict) -> list:
    """Every quantity of B1-B5 of ``mode``: JAX's value against the port's
    K seed tables."""
    k = len(tables)
    out = []
    for band in ("B1", "B2", "B3", "B4", "B5"):
        if mode not in BANDS[band]["modes"]:
            continue
        if band == "B2":
            for f in FLAGS.values():
                fj = flags(jax, f)
                share = {n: sum(bool(t["per_route"][n][f]) for t in tables)
                         / k for n in fj}
                unseen = [n for n in fj
                          if share[n] == (0.0 if fj[n] else 1.0)]
                out.append({"band": band, "quantity": f,
                            "jax_flags": "".join("R" if fj[n] else "."
                                                 for n in fj),
                            "share_set": share, "unseen": unseen,
                            "within": len(unseen) <= SPREAD["max_unseen"],
                            "probe_routes": unseen})
            continue
        jq = scalar_quantities(jax, band)
        sq = [scalar_quantities(t, band) for t in tables]
        for q, (jv, jroutes) in jq.items():
            vals = [s[q][0] for s in sq]
            m, sd, iv = prediction_interval(vals)
            within = jv == m if sd == 0.0 else iv[0] <= jv <= iv[1]
            out.append({"band": band, "quantity": q, "jax": jv,
                        "values": vals, "mean": m, "sd": sd,
                        "interval": iv, "within": within,
                        "probe_routes": [furthest_route(
                            jroutes, [s[q][1] for s in sq])]})
    return out


def spread_verdict(quantities: list, mode: str, probes: list) -> tuple:
    """A band's spread verdict from its quantities and the divergence
    probes of ``mode``: (verdict, the routes to probe)."""
    outside = [q for q in quantities if not q["within"]]
    if not outside:
        return "chaos", []
    routes = sorted({n for q in outside for n in q["probe_routes"]})
    ran = {p["route"]: p["verdict"] for p in probes
           if p["mode"] == mode and p["phase"] == "repeat"
           and p["route"] in routes}
    if "fault" in ran.values():
        return "fault", routes
    if len(ran) == len(routes) and all(v == "chaos" for v in ran.values()):
        return "unresolved", routes
    return "outside", routes


def first_difference(got: dict, want: dict):
    """The first (route, field) at which two tables differ (per route
    figures, then the aggregates, the anchor outcomes and the teach
    drift), or None."""
    def differ(a, b):   # NaN (a route with no drift sample) equals NaN
        return json.dumps(a) != json.dumps(b)

    for name in want["per_route"]:
        for f in want["per_route"][name]:
            g = got["per_route"].get(name, {}).get(f)
            if differ(g, want["per_route"][name][f]):
                return {"route": name, "field": f, "seed1": g,
                        "committed": want["per_route"][name][f]}
    for key in ("agg", "anchor", "teach_drift"):
        if differ(got[key], want[key]):
            return {"route": None, "field": key}
    return None


def spread(port_dir: Path, jax: dict, port: dict, rows: list,
           probes: list) -> dict | None:
    """The ``spread`` section over the seed files in ``port_dir/seeds``."""
    seed_dir = port_dir / SEED_DIR
    files = {m: json.loads((seed_dir / f"{m}.json").read_text())
             for m in BANDED if (seed_dir / f"{m}.json").is_file()}
    if not files:
        return None
    res = {"test": SPREAD, "t995": {m: T995[len(f["seeds"]) - 1]
                                    for m, f in files.items()},
           "modes": {}, "bands": [], "held_outside": [], "witness": {}}
    for m, f in files.items():
        tables = [f["tables"][str(s)] for s in f["seeds"]]
        qs = mode_spread(m, tables, jax[m])
        res["modes"][m] = {"seeds": f["seeds"], "quantities": qs,
                           "repeat_ticks": {str(s): f["tables"][str(s)][
                               "repeat_ticks"] for s in f["seeds"]}}
        one = f["tables"].get("1")
        if one is not None:
            diff = first_difference(one, port[m])
            res["witness"][m] = "equal" if diff is None else diff
        for band in sorted({q["band"] for q in qs}):
            bq = [q for q in qs if q["band"] == band]
            missed = any(not r["held"] for r in rows
                         if r["band"] == band and r["mode"] == m)
            verdict, routes = spread_verdict(bq, m, probes)
            outside = [q["quantity"] for q in bq if not q["within"]]
            res["bands"].append({"band": band, "mode": m, "missed": missed,
                                 "outside": outside, "probe_routes": routes,
                                 "spread": verdict})
            if not missed and outside:
                res["held_outside"].append({"band": band, "mode": m,
                                            "outside": outside})
    for r in rows:
        if not r["held"] and r["mode"] in files:
            r["spread"] = next(b["spread"] for b in res["bands"]
                               if (b["band"], b["mode"]) ==
                               (r["band"], r["mode"]))
    return res


def adopt_seed1(port_dir: Path, mode: str) -> Path:
    """Replace ``port_dir/MODE.json`` by the seed-1 table of
    ``seeds/MODE.json``: the JAX tool's keys, that seed's own executed
    repeat ticks, and the batch's wall seconds, calls and card line."""
    f = json.loads((port_dir / SEED_DIR / f"{mode}.json").read_text())
    t = dict(f["tables"]["1"])
    n = t.pop("repeat_ticks")
    executed = {"teach": f["ticks_executed"]["teach"], "repeat": n}
    wall = f["wall_s"]
    t.update(ticks_executed=executed, wall_s=wall,
             ms_per_tick={k: wall[k] / executed[k] * 1e3 for k in executed},
             repeat_calls=f["repeat_calls"], card=f["card"],
             seed_batch={"seeds": f["seeds"], "rows": f["rows"],
                         "repeat_ticks": f["ticks_executed"]["repeat"]})
    out = port_dir / f"{mode}.json"
    out.write_text(json.dumps(t, indent=1))
    return out


def route_rule(port: dict, cpu: dict, tpu: dict, port_reached: dict,
               cpu_reached: dict) -> dict:
    """The route rule (``ROUTE_RULE``) on per-route ``drift_mean`` values:
    ``port`` and ``cpu`` map a route to its values over the seeds, ``tpu``
    to the TPU table's value; ``*_reached`` map a route to its seeds'
    ``reached_final`` flags."""
    routes = {}
    for n in cpu:
        p, j, t = port[n], cpu[n], tpu[n]
        side = ("jax_above" if min(j) > max(p) else
                "jax_below" if max(j) < min(p) else None)
        both = p + j
        routes[n] = {"port": p, "jax_cpu": j, "tpu": t,
                     "port_range": [min(p), max(p)],
                     "jax_cpu_range": [min(j), max(j)],
                     "systematic": side,
                     "tpu_outside": not min(both) <= t <= max(both)}
    sides = [r["systematic"] for r in routes.values() if r["systematic"]]
    reach = None
    if REACH_ROUTE in cpu_reached and REACH_ROUTE in port_reached:
        pf, jf = port_reached[REACH_ROUTE], cpu_reached[REACH_ROUTE]
        reach = {"port": pf, "jax_cpu": jf,
                 "split": (all(pf) and not any(jf))
                 or (all(jf) and not any(pf))}
    fault = any(sides.count(d) >= ROUTE_RULE["same_direction"]
                for d in ("jax_above", "jax_below")) or bool(
        reach and reach["split"])
    n_out = sum(r["tpu_outside"] for r in routes.values())
    if fault:
        verdict = "fault"
    elif not sides and n_out >= ROUTE_RULE["tpu_outside"]:
        verdict = "platform"
    else:
        verdict = "chaos"
    return {"rule": ROUTE_RULE, "routes": routes,
            "systematic": {n: r["systematic"] for n, r in routes.items()
                           if r["systematic"]},
            "tpu_outside": [n for n, r in routes.items() if r["tpu_outside"]],
            "reach_route": reach, "verdict": verdict}


def route_values(tables: list, band: str, quantity: str, routes) -> dict:
    """Route -> the values of a band's quantity over ``tables`` (B1 and B2:
    the per-route flag as 0 / 1)."""
    out = {}
    for n in routes:
        vals = []
        for t in tables:
            if band in ("B1", "B2"):
                f = FLAGS.get(quantity, quantity)
                vals.append(float(bool(t["per_route"][n][f])))
            else:
                vals.append(scalar_quantities(t, band)[quantity][1][n])
        out[n] = vals
    return out


def cpu_reference(cpu_dir: Path, jax: dict, spread_res: dict | None) -> dict:
    """The ``cpu_reference`` section: for each mode with JAX's CPU seed
    file in ``cpu_dir``, the route rule at its routes against the port's
    seeds there (``port_seeds*.json``) and the TPU table, each table's
    events, and for each band of the mode outside the port's spread where
    JAX's CPU runs lie at those routes."""
    out = {}
    for f in sorted(cpu_dir.glob("*.json")):
        if f.stem not in BANDED:
            continue
        mode = f.stem
        ref = json.loads(f.read_text())
        routes = list(ref["routes"])
        cpu = [ref["tables"][str(s)] for s in ref["seeds"]]
        port = {}
        for p in sorted(cpu_dir.glob("port_seeds*.json")):
            d = json.loads(p.read_text())
            if d["mode"] != mode:
                continue
            for s in d["seeds"]:
                t = d["tables"][str(s)]
                if s not in port and set(routes) <= set(t["per_route"]):
                    port[s] = dict(t, source=p.name)
        seeds = sorted(port)
        ptabs = [port[s] for s in seeds]
        drift = {q: route_values(ts, "B4", "avg_drift_mean", routes)
                 for q, ts in (("port", ptabs), ("cpu", cpu))}
        reached = {q: route_values(ts, "B2", "reached_final", routes)
                   for q, ts in (("port", ptabs), ("cpu", cpu))}
        rule = route_rule(drift["port"], drift["cpu"],
                          {n: jax[mode]["per_route"][n]["drift_mean"]
                           for n in routes},
                          {n: [bool(v) for v in vs]
                           for n, vs in reached["port"].items()},
                          {n: [bool(v) for v in vs]
                           for n, vs in reached["cpu"].items()})
        teach = {n: ref["tables"][str(ref["seeds"][0])]["teach_drift"][n]
                 for n in routes}
        res = {"routes": routes, "jax_cpu_seeds": ref["seeds"],
               "port_seeds": seeds,
               "port_sources": sorted({port[s]["source"] for s in seeds}),
               "teach_equal": all(
                   {n: t["teach_drift"][n] for n in routes} == teach
                   for t in ptabs),
               "jax_cpu": {"platform": ref.get("platform"),
                           "cpu": ref.get("cpu"),
                           "jax_version": ref.get("jax_version"),
                           "ticks_executed": ref.get("ticks_executed")},
               **rule, "events": {}, "bands": []}
        for n in routes:
            res["events"][n] = {
                q: {k: [t["events"][n][k] for t in ts]
                    for k in ts[0]["events"][n]}
                for q, ts in (("port", [t for t in ptabs if "events" in t]),
                              ("jax_cpu", cpu)) if ts and "events" in ts[0]}
        bands = [] if spread_res is None else [
            q for q in spread_res["modes"].get(mode, {}).get(
                "quantities", []) if not q["within"]]
        for q in bands:
            name = q["quantity"]
            pv = route_values(ptabs, q["band"], name, routes)
            jv = route_values(cpu, q["band"], name, routes)
            tv = route_values([jax[mode]], q["band"], name, routes)
            res["bands"].append({
                "band": q["band"], "quantity": name,
                "routes": {n: {"port": pv[n], "jax_cpu": jv[n],
                               "tpu": tv[n][0],
                               "jax_cpu_within_port": all(
                                   min(pv[n]) <= v <= max(pv[n])
                                   for v in jv[n]),
                               "tpu_within_port_and_cpu": min(
                                   pv[n] + jv[n]) <= tv[n][0] <= max(
                                   pv[n] + jv[n])}
                           for n in routes}})
        out[mode] = res
    return out


def adopt_teach_card(port_dir: Path, teach_json: Path) -> list:
    """Name the card of the teach in every table of ``port_dir`` (and its
    seed files) whose ``card.teach`` is null: ``teach_json`` is
    ``tools/torch_calibrate.py --mode teach --json``'s record of a teach
    run on the card; a table takes its card line only if its teach drift
    equals that teach's to the bit (the teach is reproducible on the card,
    so the two are one teach), and records the file it took it from.
    Returns the files rewritten."""
    teach = json.loads(teach_json.read_text())
    card = teach["teach_meta"]["card"]
    if not card:
        raise SystemExit(f"{teach_json} names no card")
    out = []
    for f in sorted(port_dir.glob("*.json")) + sorted(
            (port_dir / SEED_DIR).glob("*.json")):
        t = json.loads(f.read_text())
        if not isinstance(t.get("card"), dict) or t["card"].get("teach"):
            continue
        tables = [t] if "per_route" in t else list(t["tables"].values())
        drift = json.loads(json.dumps(teach["teach_drift"]))
        if any(x["teach_drift"] != {n: drift[n] for n in x["teach_drift"]}
               for x in tables):
            raise SystemExit(f"{f}: another teach than {teach_json}'s")
        t["card"]["teach"] = card
        t["card"]["teach_from"] = teach_json.name
        f.write_text(json.dumps(t, indent=1))
        out.append(f)
    return out


def check(port_dir: Path, ref_dir: Path, ref_cpu: Path | None = None) -> dict:
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
    sp = spread(port_dir, jax, port, rows, probes)
    if sp is not None:
        res["spread"] = sp
    if ref_cpu is not None:
        res["cpu_reference"] = cpu_reference(ref_cpu, jax, sp)
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
    sp = res.get("spread")
    if sp is not None:
        print_spread(sp)
    for p in res.get("evidence", []):
        rep = p.get("repeat") or p.get("teach")
        part = rep.get("parting") or {}
        print(f"(probe) {p['route']} {p['mode']} {p['phase']}: first GT "
              f"parting at tick {part.get('tick')}, "
              f"{len(rep.get('checks', []))} ticks checked (stages "
              f"{', '.join(rep.get('stages_checked', []))}): {p['verdict']}")
    for m, c in res.get("cpu_reference", {}).items():
        print_cpu_reference(m, c)
    print(f"missed bands: {res['missed_bands'] or 'none'}")


def print_cpu_reference(mode: str, c: dict) -> None:
    print(f"=== {mode}: JAX on the CPU (seeds {c['jax_cpu_seeds']}) against "
          f"the port's seeds {c['port_seeds']} off one teach "
          f"({'equal' if c['teach_equal'] else 'DIFFERENT'} teach drift) ===")
    for n, r in c["routes"].items():
        print(f"  {n:<14} drift port [{r['port_range'][0]:.3f}, "
              f"{r['port_range'][1]:.3f}]  jax cpu [{r['jax_cpu_range'][0]:.3f}"
              f", {r['jax_cpu_range'][1]:.3f}]  tpu {r['tpu']:.3f}  "
              f"systematic {r['systematic']}  tpu outside {r['tpu_outside']}")
    if c["reach_route"] is not None:
        print(f"  {REACH_ROUTE} reached_final: port {c['reach_route']['port']}"
              f", jax cpu {c['reach_route']['jax_cpu']}")
    for b in c["bands"]:
        for n, r in b["routes"].items():
            print(f"  {b['band']} {b['quantity']:<20} {n:<14} port "
                  f"{[round(v, 3) for v in r['port']]} jax cpu "
                  f"{[round(v, 3) for v in r['jax_cpu']]} tpu "
                  f"{r['tpu']:.3f}")
    print(f"  route rule: {c['verdict']}")


def print_spread(sp: dict) -> None:
    print("=== JAX against the port's seed spread (99 % prediction "
          "interval; flags: at most "
          f"{sp['test']['max_unseen']} unseen routes) ===")
    for m, d in sp["modes"].items():
        print(f"{m}: seeds {d['seeds']}, t = {sp['t995'][m]}, repeat ticks "
              f"{d['repeat_ticks']}")
        for q in d["quantities"]:
            tag = "within" if q["within"] else "OUTSIDE"
            if "unseen" in q:
                share = " ".join(f"{v:.2f}" for v in q["share_set"].values())
                print(f"  {q['band']} {q['quantity']:<20} jax "
                      f"{q['jax_flags']}  seeds set {share}  unseen "
                      f"{q['unseen']} {tag}")
            else:
                print(f"  {q['band']} {q['quantity']:<20} jax "
                      f"{q['jax']:>9.3f}  seeds m {q['mean']:.3f} s "
                      f"{q['sd']:.3f}  [{q['interval'][0]:.3f}, "
                      f"{q['interval'][1]:.3f}] {tag} (route "
                      f"{q['probe_routes'][0]})")
    for b in sp["bands"]:
        if b["missed"] or b["outside"]:
            print(f"{b['band']} {b['mode']}: "
                  f"{'missed' if b['missed'] else 'held'}, outside "
                  f"{b['outside'] or 'none'} -> {b['spread']}"
                  + (f" (probe {b['probe_routes']})"
                     if b["probe_routes"] else ""))
    for m, w in sp["witness"].items():
        print(f"witness {m}: seed 1 against the committed table: {w}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port-dir", type=Path,
                    default=REPO / "artifacts" / "calibration_torch")
    ap.add_argument("--ref-dir", type=Path,
                    default=REPO / "artifacts" / "calibration")
    ap.add_argument("--out", type=Path, default=None,
                    help="parity.json (default: in --port-dir)")
    ap.add_argument("--ref-cpu", type=Path, default=None,
                    help="JAX's CPU seed tables off the port's teach and "
                         "the port's seeds at those routes "
                         "(tools/torch_jax_reference_probe.py)")
    ap.add_argument("--teach-card", type=Path, default=None,
                    help="a teach's record (torch_calibrate.py --mode teach "
                         "--json): name its card in the tables of that "
                         "teach that name none")
    ap.add_argument("--adopt-seed1", choices=BANDED, action="append",
                    default=[], help="replace the mode's table by its seed "
                    "file's seed-1 table first")
    args = ap.parse_args(argv)
    for m in args.adopt_seed1:
        print(f"wrote {adopt_seed1(args.port_dir, m)}")
    if args.teach_card is not None:
        for f in adopt_teach_card(args.port_dir, args.teach_card):
            print(f"named the teach's card in {f}")
    missing = [str(d / f"{m}.json") for d in (args.port_dir, args.ref_dir)
               for m in BANDED if not (d / f"{m}.json").is_file()]
    if missing:
        print(f"missing tables: {missing}", file=sys.stderr)
        return 2
    res = check(args.port_dir, args.ref_dir, args.ref_cpu)
    print_report(res)
    out = args.out or args.port_dir / "parity.json"
    out.write_text(json.dumps(res, indent=1) + "\n")
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
