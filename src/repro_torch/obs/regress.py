"""Perf-regression gate: re-run the smoke tier on the port, diff against
the committed baseline, exit non-zero on drift.

Counterpart of ``repro/obs/regress.py``, with its metric schema, bands,
comparison, rendering, snapshots and CLI:

1. **Collect** -- run the smoke suites in-process (the port's serving
   driver at ``--smoke`` scale plus tiny fig4/fig5/fig10 sweeps of
   ``benchmarks.port`` on one backend), flattening each into named
   metrics tagged ``better=lower|higher`` and ``kind=time|struct``.
   ``struct`` metrics (memory bytes, final live-point counts, exact
   range-output sizes) are deterministic functions of the seeded
   workload and get a tight band; ``time`` metrics get a wide one.
2. **Compare** -- per metric, the ratio in the worse direction against
   the committed baseline (``results/port/regress_smoke.json``, written
   from a run on the card). A metric missing from the current run is
   itself a regression.
3. **Validate** -- the port's other committed payloads under
   ``results/port/`` must parse and keep their expected shape.
4. **Record** -- append a trajectory snapshot
   (``results/port/bench/BENCH_<n>.json``); ``--replay`` re-compares a
   snapshot without re-running the suites.

``--update`` rewrites the baseline from the current run;
``--inject-scale X`` degrades every time metric by ``X`` after
collection (the self-test: replaying a snapshot with
``--inject-scale 2`` must fail the gate). ``--device`` picks where the
suites run (default: the card; ``cpu`` only when asked). The ``dist``
suite serves from a mesh of 8 lanes on that device, in-process: the
port's mesh needs no environment staged before start-up, so the
reference's subprocess has no counterpart.

Run::

    python -m repro_torch.obs.regress            # local bands, the card
    python -m repro_torch.obs.regress --ci       # CI bands
    python -m repro_torch.obs.regress --update   # new baseline
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import time

DEFAULT_BASELINE = "results/port/regress_smoke.json"
SNAPSHOT_DIR = "results/port/bench"
RESULTS_DIR = "results/port"

# tolerance bands (relative): a metric fails when it is worse than
# baseline * (1 + tol) in its bad direction (the reference's bands)
LOCAL_TIME_TOL = 2.0      # local: fail past 3x
CI_TIME_TOL = 4.0         # CI: fail past 5x
STRUCT_TOL = 0.25         # bytes/counts are deterministic: keep tight

# values below the floor compare as equal, so sub-floor jitter never
# trips a relative band (ms / q/s scale for time, 1 unit for struct)
TIME_FLOOR = 2.0
STRUCT_FLOOR = 1.0

def metric(value, better: str = "lower", kind: str = "time") -> dict:
    return {"value": float(value), "better": better, "kind": kind}


# ---------------------------------------------------------------------------
# suites (each returns {metric_name: metric(...)}; benchmark imports
# deferred so the package never imports ``benchmarks`` at load time)
# ---------------------------------------------------------------------------

def _suite_serve(verbose: bool, device=None) -> dict:
    """Serving driver at --smoke scale: one backend, every scenario."""
    from ..data import points as gen
    from ..serving import driver
    # 3 measured steps so per-op p50 is a true median
    cfg = driver.DriverCfg(n=1500, batch=128, steps=3, warmup=2,
                           queries=16, k=5)
    payload = driver.run(kinds=("spac-h",), scenarios=gen.SCENARIOS,
                         cfg=cfg, verbose=verbose, device=device)
    out: dict = {}
    for scen, r in payload["results"]["spac-h"].items():
        lat = r["latency_ms"]
        for op in ("insert", "delete", "knn", "range", "commit"):
            if lat.get(op, {}).get("count"):
                out[f"serve.{scen}.{op}_p50_ms"] = \
                    metric(lat[op]["p50_ms"])
        out[f"serve.{scen}.query_per_s"] = \
            metric(r["throughput"]["query_per_s"], "higher")
        mem = r.get("memory", {})
        out[f"serve.{scen}.mem_steady_bytes"] = \
            metric(mem.get("steady_bytes", 0), "lower", "struct")
        out[f"serve.{scen}.mem_peak_window_bytes"] = \
            metric(mem.get("peak_window_bytes", 0), "lower", "struct")
        # losing points is a correctness regression, not noise
        out[f"serve.{scen}.final_size"] = \
            metric(r["final_size"], "higher", "struct")
    return out


def _suite_fig4(verbose: bool, device=None) -> dict:
    """kNN q/s (fig4 shape) at smoke scale, auto impl only."""
    from benchmarks.port import fig4_knn
    nq = 64
    out = fig4_knn.run(n=4000, nq=nq, dist="varden", indexes=["spac-h"],
                       verbose=verbose, impls=("auto",), device=device)
    qps = fig4_knn.qps_records(out, nq, impls=("auto",))
    return {f"fig4.spac-h.{key}_qps": metric(v, "higher")
            for key, v in qps["spac-h"]["auto"].items()}


def _suite_fig5(verbose: bool, device=None) -> dict:
    """Range-report q/s + exact mean output size (fig5 shape)."""
    from benchmarks.port import fig5_range
    nq = 32
    out = fig5_range.run(n=4000, nq=nq, dist="uniform",
                         indexes=["spac-h"], verbose=verbose, device=device)
    qps = fig5_range.qps_records(out, nq)
    res: dict = {}
    for side, cell in qps["spac-h"].items():
        res[f"fig5.spac-h.{side}_qps"] = metric(cell["qps"], "higher")
        # exact query output on seeded data: deterministic (struct band)
        res[f"fig5.spac-h.{side}_avg_out"] = \
            metric(cell["avg_out"], "higher", "struct")
    return res


def _suite_fig10(verbose: bool, device=None) -> dict:
    """Batch-update throughput (fig10 shape) at smoke scale."""
    from benchmarks.port import fig10_batch
    n = 8000
    out = fig10_batch.run(n=n, dist="uniform", indexes=["spac-h"],
                          verbose=verbose, device=device)
    rec = fig10_batch.throughput_records(out, n)
    return {f"fig10.spac-h.{key}_pts_per_s": metric(v, "higher")
            for key, v in rec["spac-h"].items()}


def _suite_dist(verbose: bool, device=None) -> dict:
    """Distributed serving smoke on a simulated 8-lane mesh: the serving
    driver at --smoke scale. Gates structure only (routing balance and
    exact final sizes): 8 lanes on one device time the simulation, not
    the system."""
    from ..configs import platform
    from ..data import points as gen
    from ..serving import driver
    n_shards = 8
    cfg = driver.DriverCfg(n=1500, batch=128, steps=2, warmup=1,
                           queries=16, k=5, mesh=n_shards)
    payload = driver.run(kinds=("spac-h",), scenarios=gen.SCENARIOS,
                         cfg=cfg, verbose=verbose, device=device,
                         mesh=platform.simulate_mesh(n_shards,
                                                     device=device))
    out: dict = {}
    for scen, r in payload["results"]["spac-h"].items():
        d = r["distributed"]
        # deterministic functions of the seeded workload: final live
        # count and the per-shard balance of the key-range routing
        out[f"dist.{scen}.final_size"] = \
            metric(r["final_size"], "higher", "struct")
        out[f"dist.{scen}.shard_min_points"] = \
            metric(d["shard_min_points"], "higher", "struct")
        out[f"dist.{scen}.shard_max_points"] = \
            metric(d["shard_max_points"], "lower", "struct")
    return out


SUITES = {"serve": _suite_serve, "fig4": _suite_fig4,
          "fig5": _suite_fig5, "fig10": _suite_fig10,
          "dist": _suite_dist}


def collect(suite_names, verbose: bool = True, device=None) -> dict:
    current: dict = {}
    for name in suite_names:
        if verbose:
            print(f"[regress] suite {name}:", flush=True)
        current.update(SUITES[name](verbose, device))
    return current


# ---------------------------------------------------------------------------
# comparison
# ---------------------------------------------------------------------------

def _worse_ratio(base: float, cur: float, better: str,
                 floor: float) -> float:
    """Ratio in the metric's bad direction (>1 means worse), floored so
    tiny denominators don't explode the band."""
    b, c = max(base, floor), max(cur, floor)
    return c / b if better == "lower" else b / c


def compare(current: dict, baseline: dict, time_tol: float,
            struct_tol: float):
    """Diff two metric maps -> (rows, n_regressed). Rows are
    (name, base, cur, delta_pct, status); missing-in-current counts as
    a regression (the gate guards metric coverage too)."""
    rows, regressed = [], 0
    for name in sorted(set(baseline) | set(current)):
        b, c = baseline.get(name), current.get(name)
        if c is None:
            rows.append((name, b["value"], None, None, "MISSING"))
            regressed += 1
            continue
        if b is None:
            rows.append((name, None, c["value"], None, "new"))
            continue
        struct = c.get("kind", "time") == "struct"
        tol = struct_tol if struct else time_tol
        floor = STRUCT_FLOOR if struct else TIME_FLOOR
        bv, cv = float(b["value"]), float(c["value"])
        worse = _worse_ratio(bv, cv, c.get("better", "lower"), floor)
        delta = 100.0 * (cv - bv) / max(abs(bv), 1e-12)
        if worse > 1.0 + tol:
            status, regressed = "REGRESSED", regressed + 1
        elif worse < 1.0 / (1.0 + tol):
            status = "improved"
        else:
            status = "ok"
        rows.append((name, bv, cv, delta, status))
    return rows, regressed


def render(rows, time_tol: float, struct_tol: float) -> str:
    lines = [f"{'metric':44s} {'baseline':>12s} {'current':>12s} "
             f"{'delta':>8s}  status",
             "-" * 88]
    for name, bv, cv, delta, status in rows:
        b = "-" if bv is None else f"{bv:12,.4g}"
        c = "-" if cv is None else f"{cv:12,.4g}"
        d = "-" if delta is None else f"{delta:+7.1f}%"
        lines.append(f"{name:44s} {b:>12s} {c:>12s} {d:>8s}  {status}")
    lines.append(f"(bands: time ±{time_tol:.0%} relative, "
                 f"struct ±{struct_tol:.0%})")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# committed-payload structural validation
# ---------------------------------------------------------------------------

BASELINE_SPECS = {
    "serve_latency.json": lambda d: bool(d["results"]) and all(
        "latency_ms" in r for kind in d["results"].values()
        for r in kind.values()),
    "fig3_grid.json": lambda d: bool(d["results"]) and bool(d["validate"]),
    "fig4_knn.json": lambda d: bool(d["qps"]),
    "fig5_range.json": lambda d: bool(d["qps"]),
    "fig9_3d.json": lambda d: bool(d["results"]),
    "fig10_batch.json": lambda d: bool(d["update_pts_per_s"]),
    # the roofline payload carries the frontier tile sweep next to the
    # per-kernel cells, and the serve trace's captured plan costs
    # include the frontier kernel's route
    "roofline.json": lambda d: bool(d["results"]) and "obs" in d
    and "chosen" in d["block_sweep"],
    "serve_trace.json": lambda d: all(
        "knn_p50_ms" in r for r in d["results"].values())
    and any("pallas-frontier" in s
            for r in d["results"].values()
            for s in r["cost_model"].get("plan_costs", {})),
}


def check_baselines(root: str = RESULTS_DIR) -> list:
    """Every committed payload under ``results/port/`` must parse and
    keep its shape: a deleted or truncated one fails the gate even when
    all current numbers pass."""
    problems = []
    for name, ok in BASELINE_SPECS.items():
        path = os.path.join(root, name)
        try:
            with open(path) as f:
                payload = json.load(f)
            if not ok(payload):
                problems.append(f"{path}: expected structure missing")
        except FileNotFoundError:
            problems.append(f"{path}: committed baseline missing")
        except (ValueError, KeyError, TypeError) as exc:
            problems.append(f"{path}: {exc!r}")
    return problems


# ---------------------------------------------------------------------------
# trajectory snapshots
# ---------------------------------------------------------------------------

def next_snapshot_path(directory: str = SNAPSHOT_DIR) -> str:
    ns = [int(m.group(1)) for p in
          glob.glob(os.path.join(directory, "BENCH_*.json"))
          if (m := re.search(r"BENCH_(\d+)\.json$", p))]
    return os.path.join(directory, f"BENCH_{max(ns, default=0) + 1}.json")


def inject(current: dict, scale: float) -> dict:
    """Test hook: degrade every time metric by ``scale`` (latencies
    multiplied, throughputs divided)."""
    out = {}
    for name, c in current.items():
        c = dict(c)
        if c.get("kind", "time") == "time":
            c["value"] = (c["value"] * scale
                          if c.get("better", "lower") == "lower"
                          else c["value"] / scale)
        out[name] = c
    return out


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--suites", default=",".join(SUITES),
                    help=f"comma-separated from {sorted(SUITES)}")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    metavar="PATH")
    ap.add_argument("--update", action="store_true",
                    help="rewrite the baseline from this run and exit 0")
    ap.add_argument("--ci", action="store_true",
                    help=f"CI bands: time tolerance {CI_TIME_TOL:.0%}")
    ap.add_argument("--tol", type=float, default=None,
                    help="override the relative time-metric tolerance "
                    f"(default {LOCAL_TIME_TOL} local, {CI_TIME_TOL} "
                    "with --ci)")
    ap.add_argument("--struct-tol", type=float, default=STRUCT_TOL)
    ap.add_argument("--inject-scale", type=float, default=1.0,
                    metavar="X", help="degrade time metrics by X after "
                    "collection (self-test hook; see module docstring)")
    ap.add_argument("--replay", default=None, metavar="SNAPSHOT",
                    help="compare a previous snapshot's metrics instead "
                    "of re-running the suites")
    ap.add_argument("--snapshot", default=None, metavar="PATH",
                    help="trajectory snapshot path (default: "
                    f"{SNAPSHOT_DIR}/BENCH_<next>.json)")
    ap.add_argument("--no-snapshot", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device of the suites (default: the card)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    verbose = not args.quiet
    time_tol = args.tol if args.tol is not None else \
        (CI_TIME_TOL if args.ci else LOCAL_TIME_TOL)

    suite_names = [s for s in args.suites.split(",") if s]
    unknown = set(suite_names) - set(SUITES)
    if unknown:
        print(f"repro_torch.obs.regress: unknown suites {sorted(unknown)}",
              file=sys.stderr)
        return 2

    if args.replay:
        try:
            with open(args.replay) as f:
                current = json.load(f)["metrics"]
        except (OSError, ValueError, KeyError) as exc:
            print(f"repro_torch.obs.regress: cannot replay {args.replay}: "
                  f"{exc!r}", file=sys.stderr)
            return 2
    else:
        from ..device import resolve_device
        current = collect(suite_names, verbose=verbose,
                          device=resolve_device(args.device))
    if args.inject_scale != 1.0:
        current = inject(current, args.inject_scale)

    if args.update:
        os.makedirs(os.path.dirname(args.baseline) or ".", exist_ok=True)
        with open(args.baseline, "w") as f:
            json.dump({"created_unix": time.time(),
                       "suites": suite_names, "device": args.device,
                       "metrics": current}, f, indent=1, sort_keys=True)
        print(f"wrote regress baseline ({len(current)} metrics) -> "
              f"{args.baseline}")
        return 0

    try:
        with open(args.baseline) as f:
            base_payload = json.load(f)
        baseline = base_payload["metrics"]
    except (OSError, ValueError, KeyError) as exc:
        print(f"repro_torch.obs.regress: no usable baseline at "
              f"{args.baseline} ({exc!r}); run with --update first",
              file=sys.stderr)
        return 2

    rows, regressed = compare(current, baseline, time_tol,
                              args.struct_tol)
    problems = check_baselines()
    print(render(rows, time_tol, args.struct_tol))
    for p in problems:
        print(f"BASELINE PROBLEM: {p}")

    if not args.no_snapshot:
        snap = args.snapshot or next_snapshot_path()
        os.makedirs(os.path.dirname(snap) or ".", exist_ok=True)
        with open(snap, "w") as f:
            json.dump({
                "created_unix": time.time(), "suites": suite_names,
                "ci": args.ci, "baseline": args.baseline,
                "metrics": current, "regressed": regressed,
                "baseline_problems": problems,
                "rows": [{"name": n, "baseline": b, "current": c,
                          "delta_pct": d, "status": s}
                         for n, b, c, d, s in rows],
            }, f, indent=1, sort_keys=True)
        print(f"trajectory snapshot -> {snap}")

    failed = regressed + len(problems)
    print(f"perf gate: {'FAIL' if failed else 'PASS'} "
          f"({regressed} regressed metrics, {len(problems)} baseline "
          f"problems, {len(rows)} compared)")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
