"""Workload driver: replay deterministic mixed update/query traces
through the serving runtime and report latency percentiles.

Counterpart of ``repro/serving/driver.py``, with its defaults, flags,
payload schema and obs names. Per (backend, scenario) the driver builds
a :class:`SpatialServer` sized for the trace's peak live points, then
replays the trace's steps in the pipelined serving pattern:

1. take a snapshot of the current head version,
2. dispatch the step's delete + insert (queued on the card; only the
   dispatch time is on the critical path),
3. answer the step's kNN and range requests **against the pre-step
   snapshot** through the :class:`MicroBatcher` (requests arrive as
   single-query submissions and coalesce into one pow2-padded batch per
   op),
4. ``commit()`` -- the only barrier; its wall time is the *exposed*
   update stall, i.e. whatever the queries did not hide.

Recorded ops: ``insert`` / ``delete`` (dispatch latency), ``knn`` /
``range`` (request submit -> answers on the host side of a wait on the
card's stream) plus their ``_dispatch`` / ``_wait`` segments (host
submit+flush time vs the wait that follows it), and ``commit`` (exposed
update stall). Warm-up steps run the identical shapes first and are
dropped, so kernel builds and the query engine's pow2 bucket escalations
never land in a percentile.

Percentiles come from :mod:`repro_torch.obs` histograms: install a
recorder (or pass ``--obs-trace``) and the same sink collects the
library's own counters and spans (plan-cache traffic, batcher queue
depth and pad waste, commit stalls) and exports a Perfetto-viewable
chrome trace; ``--attributed`` replays one scenario obs-off vs obs-on
side by side and writes the attributed kNN round trip.

The trace goes to the device in bulk before the server is built (set-up,
not timed): an insert or delete of host memory would be a synchronising
copy on the dispatch path. Query requests arrive as host rows, as in the
reference, and go over once per coalesced batch.

Port-only additions: ``--device`` (default: the card; a host without
CUDA raises unless ``--device cpu``), the spac family built at the
trace's 20-bit coordinate width (:func:`build_params`) and, in
:func:`run`'s payload, a ``details`` entry per (kind, scenario) with the
request units answered in the measured window, the trace's expected
final size, kernel launches (:data:`KERNELS`) and, when a recorder is
installed, the run's obs counter deltas, the commits' cumulative
recoveries by step and, on the card, the peak allocated bytes.

``--mesh N`` serves from a :class:`repro_torch.core.index.DistributedIndex`
over N lanes on ``--device`` (:func:`repro_torch.configs.platform.simulate_mesh`)
and adds the reference's ``distributed`` section (live points by shard,
the routing-drop counter) and ``server.shard<i>.live_points`` gauges.

Scenarios are ``repro_torch.data.points.SCENARIOS``: churn over each
point distribution (uniform / sweepline / varden) plus the dynamic
shapes ``moving-objects`` and ``sliding-window``. The port's generators
are seeded numpy: the same seed gives other points than the reference's
``jax.random`` streams.

Run:
  PYTHONPATH=src python -m repro_torch.serving.driver --kinds porth,spac-h
  PYTHONPATH=src python -m repro_torch.serving.driver --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.serving.driver --smoke --mesh 8 \
      --device cpu
  PYTHONPATH=src python -m repro_torch.serving.driver --json  # results/port/
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from .. import obs
from ..configs import platform
from ..core.index import get_backend
from ..data import points as gen
from ..device import resolve_device
from ..kernels.bbox import kernel as bbox_kernel
from ..kernels.frontier import kernel as frontier_kernel
from ..kernels.knn import kernel as knn_kernel
from ..kernels.morton import kernel as morton_kernel
from ..kernels.sieve import kernel as sieve_kernel
from .batcher import MicroBatcher
from .metrics import LatencyRecorder
from .server import SpatialServer

DEFAULT_KINDS = ("porth", "spac-h")
DEFAULT_JSON = "results/port/serve_latency.json"
DEFAULT_OBS_TRACE = "results/port/obs_trace.json"
DEFAULT_SERVE_TRACE = "results/port/serve_trace.json"

#: the spatial path's CUDA kernels, by name, for the launch counts
KERNELS = {"knn_flat": knn_kernel, "knn_frontier": frontier_kernel,
           "row_bbox": bbox_kernel, "sieve": sieve_kernel,
           "morton": morton_kernel}

#: the generators' coordinates lie in [0, DEFAULT_HI); the spac family
#: and zd quantize that many bits per coordinate (see :func:`build_params`)
COORD_BITS = (gen.DEFAULT_HI - 1).bit_length()

@dataclasses.dataclass(frozen=True)
class DriverCfg:
    n: int = 20_000           # bootstrap / live-set size
    batch: int = 512          # update batch per step
    steps: int = 6            # measured steps
    warmup: int = 2           # untimed steps (same shapes) dropped
    queries: int = 64         # kNN + range requests per step
    k: int = 10
    box_frac: int = 64        # range boxes span DEFAULT_HI / box_frac
    window: int = 4           # server version window
    # admission knob: high default so flushes are size-triggered (one
    # pow2 shape per op); lower it to trade throughput for per-request
    # latency
    max_delay_ms: float = 50.0
    seed: int = 0
    dim: int = 2
    phi: int = 32
    mesh: int = 0             # shard count (0 = single device)


def _query_stream(cfg: DriverCfg, scenario: str, step: int):
    """Deterministic per-step query load: kNN points from the scenario's
    distribution (uniform for the dynamic shapes) + range boxes, as host
    rows (requests arrive off the wire)."""
    dist = scenario if scenario in gen.GENERATORS else "uniform"
    rng = np.random.default_rng([cfg.seed + 7, step])
    qpts = gen.GENERATORS[dist](rng, cfg.queries, cfg.dim)
    lo, hi = gen.query_boxes(rng, cfg.queries, cfg.dim,
                             gen.DEFAULT_HI // cfg.box_frac)
    return qpts, lo, hi


def build_params(kind: str) -> dict:
    """Build parameters the driver passes to ``SpatialServer.build``: the
    trace's coordinate width as ``coord_bits`` for the kinds that take
    one. The reference's driver keeps the spac family's default of 30
    bits, which puts 10^7 points of [0, 2^20) on 4,096 Hilbert codes:
    there a batch of 10^5 inserts overflows its rows and the replay's
    compaction does not fit an 80 GB card."""
    if "coord_bits" in get_backend(kind).build_params:
        return {"coord_bits": COORD_BITS}
    return {}


def _wait(dev: torch.device) -> None:
    """Wait for the work queued on ``dev``'s current stream (the
    reference's ``jax.block_until_ready`` of the answers); nothing is
    queued on the CPU."""
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def _on_device(a, dev):
    return None if a is None else torch.as_tensor(a, device=dev)


def _rows(a) -> int:
    return 0 if a is None else int(a.shape[0])


def run_one(kind: str, scenario: str, cfg: DriverCfg,
            verbose: bool = False, mesh=None, device=None,
            details: dict | None = None) -> dict:
    """Replay one (backend, scenario) trace on ``device`` (default: the
    card); returns latency summary + sustained throughput for the
    measured window, in the reference's schema. With ``mesh`` the
    server's head is a :class:`DistributedIndex` over the mesh's lanes
    (the trace goes to lane 0's device) and the summary gains a
    per-shard ``distributed`` section. A ``details`` dict is filled with
    the port-only numbers (see the module docstring)."""
    dev = resolve_device(device) if mesh is None else mesh.devices[0]
    total = cfg.warmup + cfg.steps
    trace = gen.make_trace(scenario, seed=cfg.seed, n=cfg.n,
                           batch=cfg.batch, steps=total, dim=cfg.dim)
    boot = torch.as_tensor(trace.bootstrap, device=dev)
    steps = [(_on_device(s.delete, dev), _on_device(s.insert, dev))
             for s in trace.steps]
    for mod in KERNELS.values():
        mod.reset_launch_count()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    counters0 = dict(obs.recorder().counters) if obs.enabled() else None
    t0 = time.perf_counter()
    srv = SpatialServer.build(kind, boot, phi=cfg.phi,
                              capacity_points=trace.max_live,
                              window=cfg.window, device=dev, mesh=mesh,
                              **build_params(kind))
    srv.head_index.block_until_ready()
    build_s = time.perf_counter() - t0
    batcher = MicroBatcher(max_batch=cfg.queries,
                           max_delay_s=cfg.max_delay_ms / 1e3)
    # share the installed obs recorder (if any) so latency histograms,
    # the library's own counters/spans, and trace export use one sink
    rec = LatencyRecorder(recorder=obs.recorder())
    measured_updates = 0
    recoveries = []
    for s, (dels, ins) in enumerate(steps):
        if s == cfg.warmup:
            rec.reset()   # drop warm-up: kernel builds + escalations
        snap = srv.snapshot()                       # pre-step version
        batcher.target = snap
        if dels is not None:
            with rec.timer("delete", _rows(dels)):
                srv.delete(dels)
        if ins is not None:
            with rec.timer("insert", _rows(ins)):
                srv.insert(ins)
        qpts, lo, hi = _query_stream(cfg, scenario, s)
        t1 = time.perf_counter()
        knn_tickets = [batcher.submit_knn(qpts[i], cfg.k)
                       for i in range(cfg.queries)]
        answers = [t.result() for t in knn_tickets]
        t2 = time.perf_counter()       # dispatched: host work done
        _wait(dev)
        t3 = time.perf_counter()       # device drained
        rec.record("knn", t3 - t1, cfg.queries, start=t1)
        rec.record("knn_dispatch", t2 - t1, cfg.queries)
        rec.record("knn_wait", t3 - t2, cfg.queries)
        t1 = time.perf_counter()
        rng_tickets = [batcher.submit_range_count(lo[i], hi[i])
                       for i in range(cfg.queries)]
        answers = [t.result() for t in rng_tickets]
        t2 = time.perf_counter()
        _wait(dev)
        t3 = time.perf_counter()
        rec.record("range", t3 - t1, cfg.queries, start=t1)
        rec.record("range_dispatch", t2 - t1, cfg.queries)
        rec.record("range_wait", t3 - t2, cfg.queries)
        del answers
        with rec.timer("commit"):                   # exposed stall
            srv.commit()
        recoveries.append(srv.stats["recoveries"])
        if s >= cfg.warmup:
            measured_updates += _rows(dels) + _rows(ins)
    wall = rec.wall_s
    mem = srv.memory_report()
    out = {
        "latency_ms": rec.latency_summary(),
        "throughput": {
            "query_per_s": rec.count("knn") + rec.count("range"),
            "update_pts_per_s": measured_updates,
            "wall_s": wall,
        },
        # steady = head-version bytes at the end, peak = retained-window
        # high-water mark; both from tensor metadata (no device read)
        "memory": {
            "steady_bytes": mem["live_bytes"],
            "peak_window_bytes": mem["peak_window_bytes"],
            "window_bytes": mem["window_bytes"],
            "evicted_bytes": mem["evicted_bytes"],
            "evictions": mem["evictions"],
        },
        "build_s": build_s,
        "final_size": len(srv.head_index),
        "recoveries": srv.stats["recoveries"],
    }
    if mesh is not None:
        # per-shard balance: live points per shard from the key-range
        # routing, plus the cumulative routing-drop counter (0 after the
        # checked replay of any drop)
        sizes = srv.head_index.shard_sizes().tolist()
        for i, n_live in enumerate(sizes):
            obs.gauge(f"server.shard{i}.live_points", int(n_live))
        out["distributed"] = {
            "n_shards": len(sizes),
            "shard_points": [int(n_live) for n_live in sizes],
            "shard_min_points": int(min(sizes)),
            "shard_max_points": int(max(sizes)),
            "dropped": int(srv.head_index.dropped),
        }
    for key in ("query_per_s", "update_pts_per_s"):
        out["throughput"][key] = out["throughput"][key] / max(wall, 1e-9)
    if details is not None:
        details["units"] = {op: rec.count(op) for op in
                            ("insert", "delete", "knn", "range")}
        details["expected_size"] = trace.final_size
        details["recoveries_by_step"] = recoveries
        details["peak_allocated_bytes"] = (
            torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
        details["launches"] = {name: mod.launch_count()
                               for name, mod in KERNELS.items()}
        if counters0 is not None:
            now = obs.recorder().counters
            details["counters"] = {
                name: v - counters0.get(name, 0)
                for name, v in sorted(now.items())
                if v != counters0.get(name, 0)}
    if verbose:
        lat = out["latency_ms"]
        cells = " ".join(
            f"{op} p50={lat[op]['p50_ms']:7.2f} p99={lat[op]['p99_ms']:7.2f}"
            for op in ("insert", "delete", "knn", "range", "commit")
            if op in lat and lat[op]["count"])
        print(f"  [{kind}/{scenario}] {cells} | "
              f"{out['throughput']['query_per_s']:,.0f} q/s, "
              f"{out['throughput']['update_pts_per_s']:,.0f} upd-pts/s | "
              f"mem {obs.fmt_bytes(mem['live_bytes'])} steady / "
              f"{obs.fmt_bytes(mem['peak_window_bytes'])} peak",
              flush=True)
        if mesh is not None:
            d = out["distributed"]
            print(f"    shards={d['n_shards']} "
                  f"points/shard min={d['shard_min_points']} "
                  f"max={d['shard_max_points']} "
                  f"dropped={d['dropped']}", flush=True)
    return out


def run(kinds=DEFAULT_KINDS, scenarios=gen.SCENARIOS,
        cfg: DriverCfg = DriverCfg(), verbose: bool = True,
        mesh=None, device=None) -> dict:
    """Sweep kinds x scenarios; returns the full json-able payload (the
    reference's, plus ``details``)."""
    payload = {"config": dataclasses.asdict(cfg), "kinds": list(kinds),
               "scenarios": list(scenarios), "results": {}, "details": {}}
    for kind in kinds:
        if verbose:
            print(f"{kind}:", flush=True)
        payload["results"][kind], payload["details"][kind] = {}, {}
        for scenario in scenarios:
            details = payload["details"][kind][scenario] = {}
            payload["results"][kind][scenario] = run_one(
                kind, scenario, cfg, verbose=verbose, mesh=mesh,
                device=device, details=details)
    return payload


def _p50(stats: dict | None) -> float:
    return float((stats or {}).get("p50_ms", 0.0))


def _cost_model_section(rec: obs.Recorder) -> dict:
    """Expected-vs-observed device time from the captured plan costs.

    The obs-on run captures each plan once (``plan.cost.*``, see
    :mod:`repro_torch.obs.costs`) during its warm-up. The reference
    turns the kNN plan's compiled bytes into an expected time through
    the roofline baseline's byte rate; the port measures the plan's
    device time directly, so the expected device time of one kNN batch
    is the captured plan's ``device_us``: the kNN plan with the most of
    it, the converged one. Compare it with the observed wait to see what
    the device does beyond its kernels' time (launch gaps, queueing)."""
    costs = obs.costs.plan_costs(rec.counters)
    out = {"plan_costs": costs, "knn_plan_sig": None, "knn_plan_bytes": None,
           "knn_plan_device_us": None, "knn_plan_launches": None,
           "knn_plan_kernels": None, "knn_expected_device_ms": None,
           "rate_source": None}
    knn = {s: c for s, c in costs.items() if s.startswith("knn.")}
    if not knn:
        return out
    sig = max(knn, key=lambda s: knn[s].get("device_us", 0))
    out.update(knn_plan_sig=sig,
               knn_plan_device_us=knn[sig].get("device_us", 0),
               knn_plan_launches=knn[sig].get("launches", 0),
               knn_plan_kernels=rec.cost_kernels.get(sig),
               knn_expected_device_ms=knn[sig].get("device_us", 0) / 1e3,
               rate_source="plan.cost device_us (torch.profiler, one "
                           "warm-up call of the plan)")
    return out


def run_attributed(kinds=DEFAULT_KINDS, scenario: str = "uniform",
                   cfg: DriverCfg = DriverCfg(), verbose: bool = True,
                   device=None) -> dict:
    """Replay one scenario per backend twice -- obs disabled, then obs
    enabled -- and attribute the kNN round trip from the enabled run's
    obs data: batcher queue wait, host dispatch (submit, flush, plan and
    launch), pow2 buffer escalation, device wait. The side-by-side p50s
    show what enabling obs costs the round trip."""
    payload = {"config": dataclasses.asdict(cfg), "scenario": scenario,
               "kinds": list(kinds), "results": {}}
    for kind in kinds:
        assert not obs.enabled(), "attributed baseline needs obs off"
        off = run_one(kind, scenario, cfg, device=device)
        # capture_costs: the obs-on run also profiles each plan once, at
        # its first call (in the warm-up, so measured percentiles never
        # see it)
        with obs.recording(obs.Recorder(capture_costs=True)) as rec_obs:
            on = run_one(kind, scenario, cfg, device=device)
            report = rec_obs.report()
        hists, counters = report["hists"], report["counters"]
        lat_off, lat_on = off["latency_ms"], on["latency_ms"]
        p50_off, p50_on = _p50(lat_off.get("knn")), _p50(lat_on.get("knn"))
        wait = hists.get("batcher.wait_s", {})
        esc = hists.get("engine.escalation_rounds", {})
        requests = counters.get("engine.plan_request", 0)
        misses = counters.get("engine.plan_miss", 0)
        entry = {
            "obs_off": {"latency_ms": lat_off,
                        "throughput": off["throughput"]},
            "obs_on": {"latency_ms": lat_on,
                       "throughput": on["throughput"]},
            "knn_p50_ms": {"obs_off": p50_off, "obs_on": p50_on,
                           "obs_overhead_pct": 0.0 if not p50_off else
                           100.0 * (p50_on - p50_off) / p50_off},
            # round-trip attribution (ms at p50, from the obs-on run):
            # queue wait happens before dispatch, so segments sum to
            # roughly wait + round_trip for a coalesced request
            "knn_attribution_ms": {
                "batcher_wait_p50": wait.get("p50", 0.0) * 1e3,
                "dispatch_p50": _p50(lat_on.get("knn_dispatch")),
                "device_wait_p50": _p50(lat_on.get("knn_wait")),
                "round_trip_p50": p50_on,
            },
            "plan_cache": {
                "requests": requests, "misses": misses,
                "hit_rate": 0.0 if not requests else
                (requests - misses) / requests,
                "traces": counters.get("engine.trace", 0),
            },
            "escalation": {
                "calls": esc.get("count", 0),
                "rounds_p50": esc.get("p50", 0.0),
                "rounds_max": esc.get("max", 0.0),
                "extra_rounds": counters.get("engine.escalation", 0),
            },
            "batcher": {
                "coalesce_rows_p50":
                    hists.get("batcher.coalesce_rows", {}).get("p50", 0.0),
                "pad_rows_p50":
                    hists.get("batcher.pad_rows", {}).get("p50", 0.0),
                "flushes": {k.split(".", 2)[2]: v
                            for k, v in counters.items()
                            if k.startswith("batcher.flush.")},
            },
            "cost_model": {
                **_cost_model_section(rec_obs),
                "knn_device_wait_observed_ms":
                    _p50(lat_on.get("knn_wait")),
            },
            "memory": {"obs_off": off.get("memory"),
                       "obs_on": on.get("memory")},
        }
        payload["results"][kind] = entry
        if verbose:
            a = entry["knn_attribution_ms"]
            print(f"[{kind}/{scenario}] knn p50 obs_off={p50_off:.2f}ms "
                  f"obs_on={p50_on:.2f}ms "
                  f"({entry['knn_p50_ms']['obs_overhead_pct']:+.1f}%) | "
                  f"wait={a['batcher_wait_p50']:.2f} "
                  f"dispatch={a['dispatch_p50']:.2f} "
                  f"device={a['device_wait_p50']:.2f}", flush=True)
    return payload


def _write_json(path: str, payload: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kinds", default=",".join(DEFAULT_KINDS),
                    help="comma-separated registered backends")
    ap.add_argument("--scenarios", default=",".join(gen.SCENARIOS),
                    help=f"comma-separated from {gen.SCENARIOS}")
    ap.add_argument("--n", type=int, default=DriverCfg.n)
    ap.add_argument("--batch", type=int, default=DriverCfg.batch)
    ap.add_argument("--steps", type=int, default=DriverCfg.steps)
    ap.add_argument("--warmup", type=int, default=DriverCfg.warmup)
    ap.add_argument("--queries", type=int, default=DriverCfg.queries)
    ap.add_argument("--k", type=int, default=DriverCfg.k)
    ap.add_argument("--window", type=int, default=DriverCfg.window)
    ap.add_argument("--max-delay-ms", type=float,
                    default=DriverCfg.max_delay_ms)
    ap.add_argument("--seed", type=int, default=DriverCfg.seed)
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="serve from a DistributedIndex sharded over N "
                    "lanes on --device (adds per-shard metrics)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; a host "
                    "without CUDA needs --device cpu)")
    ap.add_argument("--json", nargs="?", const=DEFAULT_JSON, default=None,
                    metavar="PATH", help="write the latency/throughput "
                    f"payload (default {DEFAULT_JSON})")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny end-to-end trace: one backend, every "
                    "scenario, seconds not minutes")
    ap.add_argument("--obs-trace", nargs="?", const=DEFAULT_OBS_TRACE,
                    default=None, metavar="PATH",
                    help="record the run through repro_torch.obs and "
                    "export a chrome trace (view: python -m "
                    f"repro_torch.obs.view PATH; default {DEFAULT_OBS_TRACE})")
    ap.add_argument("--attributed", nargs="?", const=DEFAULT_SERVE_TRACE,
                    default=None, metavar="PATH",
                    help="obs-off vs obs-on side-by-side on the first "
                    "--scenarios entry, with the kNN round trip broken "
                    "into batcher-wait/dispatch/device segments "
                    f"(default {DEFAULT_SERVE_TRACE})")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    mesh = (platform.simulate_mesh(args.mesh, device=device) if args.mesh
            else None)
    rec_obs = obs.install(obs.Recorder()) if args.obs_trace else None

    def _export_obs():
        if rec_obs is None:
            return
        obs.write_chrome_trace(rec_obs, args.obs_trace)
        obs.uninstall()
        print(f"wrote obs chrome trace -> {args.obs_trace} "
              f"(view: python -m repro_torch.obs.view {args.obs_trace})")

    if args.smoke:
        cfg = DriverCfg(n=1500, batch=128, steps=2, warmup=1, queries=16,
                        k=5, seed=args.seed, mesh=args.mesh)
        payload = run(kinds=("spac-h",), scenarios=gen.SCENARIOS, cfg=cfg,
                      mesh=mesh, device=device)
        ops = {op for r in payload["results"]["spac-h"].values()
               for op, s in r["latency_ms"].items() if s["count"]}
        assert {"insert", "delete", "knn", "range", "commit"} <= ops, ops
        if mesh is not None:
            for r in payload["results"]["spac-h"].values():
                d = r["distributed"]
                assert d["n_shards"] == args.mesh, d
                assert sum(d["shard_points"]) == r["final_size"], d
        _export_obs()
        if args.json:
            _write_json(args.json, payload)
            print(f"wrote smoke payload -> {args.json}")
        print("serving driver smoke OK")
        return
    cfg = DriverCfg(n=args.n, batch=args.batch, steps=args.steps,
                    warmup=args.warmup, queries=args.queries, k=args.k,
                    window=args.window, max_delay_ms=args.max_delay_ms,
                    seed=args.seed, mesh=args.mesh)
    if args.attributed:
        assert rec_obs is None, \
            "--attributed manages its own recorder; drop --obs-trace"
        assert mesh is None, \
            "--attributed compares obs on/off single-device; drop --mesh"
        scenario = args.scenarios.split(",")[0]
        payload = run_attributed(kinds=tuple(args.kinds.split(",")),
                                 scenario=scenario, cfg=cfg, device=device)
        _write_json(args.attributed, payload)
        print(f"wrote attributed serve baseline -> {args.attributed}")
        return
    payload = run(kinds=args.kinds.split(","),
                  scenarios=args.scenarios.split(","), cfg=cfg, mesh=mesh,
                  device=device)
    _export_obs()
    if args.json:
        _write_json(args.json, payload)
        print(f"wrote serving latency percentiles -> {args.json}")


if __name__ == "__main__":
    main()
