"""Roofline report of the port's spatial kernels, and the frontier
kernel's tile sweep.

Counterpart of the spatial part of ``benchmarks/roofline.py``. Spatial
sweep (``--spatial`` / ``--json``): per (backend, kernel) -- kNN on the
``auto`` route (the frontier kernel at these sizes), kNN on the chunked
traversal, range-count, batch insert -- time the facade call the figure
scripts time, divide the reference's analytic useful-work model (flops,
minimum bytes moved; :func:`kernel_models`) by the measured time, and
report achieved GFLOP/s, GB/s, arithmetic intensity and each cell's
share of the H100's peaks (:data:`HBM_BYTES_PER_S`,
:data:`FP32_OPS_PER_S`, the constants of ``chip_smoke.py``). The sweep
runs under a ``Recorder(capture_costs=True)``: each cell also carries
the device time and kernel launches of the plan its calls captured
(``plan_sig``, ``plan_device_us``, ``plan_launches``, ``plan_kernels``;
:mod:`repro_torch.obs.costs`), where the reference carries compiled HLO
bytes.

Tile sweep (``--block-sweep``): every ``(block_q, block_p)`` of the
frontier kernel (``knn_frontier_impl(..., impl="cuda")``; the kernel
takes ``block_q`` up to 32 and ``block_p`` up to 512, and the payload
lists the larger tiles as ``refused``) on each backend's view, timed in
``repeats`` passes, each cell's answers held bit-equal to the default
tile's. The
chosen tile minimises the total time across backends; it replaces the
default in ``repro_torch/kernels/frontier/tuning.py`` only when it beats
the default by more than the spread between passes (``adopt``).

Not ported: the reference's LM dry-run tables (``load``, ``table``),
which read XLA artifacts of a TPU mesh (ROADMAP queue 1, item 5.3).

Run:  python -m benchmarks.port.roofline --spatial --n 10000000
      python -m benchmarks.port.roofline --json --block-sweep \\
          --n 10000000     # results/port/roofline.json
      python -m benchmarks.port.roofline --spatial --n 20000 --device cpu
"""

from __future__ import annotations

import argparse
import functools
import math

import torch

from repro_torch import obs
from repro_torch.data import points as gen
from repro_torch.kernels.frontier import kernel as frontier_kernel
from repro_torch.kernels.frontier import tuning
from repro_torch.kernels.frontier.ops import knn_frontier_impl

from . import common

SPATIAL_KINDS = ("porth", "spac-h")
DEFAULT_JSON = f"{common.RESULTS}/roofline.json"

# published H100 SXM peaks (NVIDIA data sheet), as in chip_smoke.py
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


# -- spatial-kernel roofline ------------------------------------------------

def kernel_models(n: int, nq: int, k: int, dim: int, batch: int) -> dict:
    """Analytic useful-work models: (flops, minimum bytes moved) per
    kernel at float32 (the reference's): a brute-force distance matrix
    for kNN, one compare pass for range-count, a resort-merge for
    insert, so achieved/peak reads as the price of the structure."""
    f32 = 4
    return {
        # nq*n distances (sub, mul, add per dim) + running k-min compare
        "knn": (nq * n * (3 * dim + 1),
                f32 * (n * dim + nq * dim + 2 * nq * k)),
        # two bound compares per dim per (box, point) + the reduction
        "range_count": (nq * n * (2 * dim + 1),
                        f32 * (n * dim + 2 * nq * dim + nq)),
        # merge a sorted batch into the sorted live set: compare-bound
        "insert": ((n + batch) * max(1.0, math.log2(n + batch)),
                   f32 * dim * (2 * n + 2 * batch)),
    }


def spatial_sweep(kinds=SPATIAL_KINDS, n: int = 20_000, nq: int = 256,
                  k: int = 10, dist: str = "uniform", box_frac: int = 64,
                  batch_ratio: float = 0.01, phi: int = 32,
                  verbose: bool = True, device=None) -> dict:
    """Time the fig4/fig5/fig10-shaped kernels per backend and attach
    achieved-vs-model numbers; returns the json-able payload (with the
    obs report recorded over the sweep)."""
    dim = 2
    batch = max(int(n * batch_ratio), 64)
    pts = common.on_device(common.points_for(dist, n), device)
    ind_q = common.on_device(common.knn_queries(dist, nq)[0], device)
    lo, hi = (common.on_device(a, device) for a in gen.query_boxes(
        9, nq, dim, gen.DEFAULT_HI // box_frac))
    ins = common.on_device(common.points_for(dist, batch, seed=3), device)
    models = kernel_models(n, nq, k, dim, batch)
    models["knn_chunked"] = models["knn"]   # same useful work, old route
    results: dict = {}
    # capture_costs: each new plan runs once more under the profiler
    # (during timed's warm-up), so every cell carries its plan's device
    # time next to the analytic model
    with obs.recording(obs.Recorder(capture_costs=True)) as rec_obs:
        for kind in kinds:
            idx = common.build_index(kind, pts, phi=phi,
                                     capacity_points=n + batch,
                                     device=device)
            timers = {
                # auto routes to the frontier kernel at this size;
                # knn_chunked pins the chunked traversal beside it
                "knn": lambda: common.timed(idx.knn, ind_q, k),
                "knn_chunked": lambda: common.timed(
                    functools.partial(idx.knn, impl="frontier"),
                    ind_q, k),
                "range_count": lambda: common.timed(idx.range_count,
                                                    lo, hi),
                "insert": lambda: common.timed(idx.insert, ins),
            }
            sig_prefix = {"knn": "knn.", "knn_chunked": "knn.",
                          "range_count": "range_count.",
                          "insert": f"update.{kind}.insert."}
            row: dict = {}
            for kern, run_timed in timers.items():
                seen = set(obs.costs.plan_costs(rec_obs.counters))
                t, _ = run_timed()
                flops, byts = models[kern]
                cell = {
                    "time_s": t,
                    "model_flops": flops,
                    "model_bytes": byts,
                    "achieved_gflops_s": flops / t / 1e9,
                    "achieved_gbytes_s": byts / t / 1e9,
                    "intensity_flop_per_byte": flops / byts,
                    "peak_share_bytes": byts / t / HBM_BYTES_PER_S,
                    "peak_share_flops": flops / t / FP32_OPS_PER_S,
                }
                # the plan this kernel's calls captured; escalation can
                # build several -- the one with the most device time is
                # the converged plan that dominates steady state
                captured = {
                    s: c for s, c in
                    obs.costs.plan_costs(rec_obs.counters).items()
                    if s not in seen and s.startswith(sig_prefix[kern])}
                if captured:
                    top = max(captured,
                              key=lambda s: captured[s].get("device_us", 0))
                    cell["plan_sig"] = top
                    cell["plan_device_us"] = captured[top].get("device_us", 0)
                    cell["plan_launches"] = captured[top].get("launches", 0)
                    cell["plan_kernels"] = rec_obs.cost_kernels.get(top)
                    # <1: the rest of the call's time is off the device
                    # (host work, launch gaps, syncs)
                    cell["plan_device_share"] = \
                        cell["plan_device_us"] / 1e6 / t
                row[kern] = cell
                base = f"roofline.{kind}.{kern}"
                obs.count(f"{base}.model_flops", flops)
                obs.count(f"{base}.model_bytes", byts)
                obs.gauge(f"{base}.gflops_s", cell["achieved_gflops_s"])
                obs.gauge(f"{base}.gbytes_s", cell["achieved_gbytes_s"])
            results[kind] = row
            del idx, timers
            common.release()
            if verbose:
                cells = " ".join(
                    f"{kern} {row[kern]['time_s'] * 1e3:8.2f}ms "
                    f"{row[kern]['achieved_gflops_s']:6.2f}GF/s"
                    for kern in row)
                print(f"{kind:10s} {cells}", flush=True)
        report = rec_obs.report()
    return {"config": {"n": n, "nq": nq, "k": k, "dim": dim,
                       "dist": dist, "batch": batch, "phi": phi},
            "device": common.device_name(device),
            "kinds": list(kinds), "results": results, "obs": report}


FRONTIER_BLOCK_QS = (8, 16, 32)          # the kernel takes block_q <= 32
FRONTIER_BLOCK_PS = (128, 256, 512, 1024)


def block_sweep(kinds=SPATIAL_KINDS, n: int = 20_000, nq: int = 64,
                k: int = 10, dist: str = "uniform", phi: int = 32,
                block_qs=FRONTIER_BLOCK_QS, block_ps=FRONTIER_BLOCK_PS,
                repeats: int = 2, verbose: bool = True,
                device=None) -> dict:
    """Tile sweep of the frontier kernel: time every (block_q, block_p)
    cell ``repeats`` times over, check its ``(d2, ids)`` bit-equal to
    the default tile's, record achieved GB/s per cell as obs gauges
    (``roofline.block_sweep.<kind>.bq<q>.bp<p>.gbytes_s``) and pick the
    tile with the least total time across backends."""
    impl = "cuda"
    default = tuning.tiles(impl)
    pts = common.on_device(common.points_for(dist, n), device)
    q = common.on_device(common.knn_queries(dist, nq)[0], device)
    byts = kernel_models(n, nq, k, 2, 64)["knn"][1]
    # the kernel reads a group's flags in one pass of a warp: at most
    # MAX_GROUP points a group, so larger block_p are refused
    limit = frontier_kernel.MAX_GROUP
    tiles = [(bq, bp) for bq in block_qs for bp in block_ps if bp <= limit]
    refused = {f"bq{bq}.bp{bp}": f"block_p above the kernel's MAX_GROUP "
               f"({limit} points a group)"
               for bq in block_qs for bp in block_ps if bp > limit}
    cells: dict = {}
    totals = {tile: [0.0] * repeats for tile in tiles}
    with obs.recording() as rec_obs:
        for kind in kinds:
            idx = common.build_index(kind, pts, phi=phi, device=device)
            v = idx.view()
            args = (v.pts, v.valid, v.active, v.bbox_lo, v.bbox_hi, q)
            want = knn_frontier_impl(*args, k=k, impl=impl)
            for rep in range(repeats):
                for bq, bp in tiles:
                    t, got = common.timed(knn_frontier_impl, *args, k=k,
                                          impl=impl, block_q=bq,
                                          block_p=bp)
                    key = f"{kind}.bq{bq}.bp{bp}"
                    cell = cells.setdefault(key, {"times_s": [],
                                                  "bit_equal": True})
                    cell["times_s"].append(t)
                    cell["bit_equal"] &= bool(
                        torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1]))
                    totals[(bq, bp)][rep] += t
            for bq, bp in tiles:
                cell = cells[f"{kind}.bq{bq}.bp{bp}"]
                cell["time_s"] = min(cell["times_s"])
                cell["achieved_gbytes_s"] = byts / cell["time_s"] / 1e9
                obs.gauge(f"roofline.block_sweep.{kind}.bq{bq}.bp{bp}"
                          f".gbytes_s", cell["achieved_gbytes_s"])
            del idx, v, args, want
            common.release()
            if verbose:
                best = min((c["time_s"], key) for key, c in cells.items()
                           if key.startswith(f"{kind}."))
                print(f"{kind:10s} best tile {best[1]} "
                      f"{best[0] * 1e3:.3f}ms", flush=True)
        report = rec_obs.report()
    mean = {tile: sum(ts) / repeats for tile, ts in totals.items()}
    spread = {tile: max(ts) - min(ts) for tile, ts in totals.items()}
    bq, bp = min(mean, key=mean.get)
    margin = mean[default] - mean[(bq, bp)]
    adopt = (bq, bp) != default and \
        margin > max(spread[(bq, bp)], spread[default])
    chosen = {"block_q": bq, "block_p": bp,
              "rule": "min total time across kinds",
              "total_s": mean[(bq, bp)], "spread_s": spread[(bq, bp)],
              "default": {"block_q": default[0], "block_p": default[1],
                          "total_s": mean[default],
                          "spread_s": spread[default]},
              "margin_s": margin, "adopt": adopt}
    if verbose:
        print(f"chosen tile: block_q={bq} block_p={bp} "
              f"({mean[(bq, bp)] * 1e3:.3f} ms total, default "
              f"{default} {mean[default] * 1e3:.3f} ms; adopt={adopt})",
              flush=True)
    return {"config": {"n": n, "nq": nq, "k": k, "dist": dist,
                       "phi": phi, "kinds": list(kinds), "impl": impl,
                       "repeats": repeats},
            "device": common.device_name(device),
            "cells": cells,
            "totals_s": {f"bq{t[0]}.bp{t[1]}": ts
                         for t, ts in totals.items()},
            "all_bit_equal": all(c["bit_equal"] for c in cells.values()),
            "refused": refused, "chosen": chosen, "obs": report}


def spatial_table(payload: dict) -> str:
    hdr = (f"{'index':10s} {'kernel':12s} {'time_ms':>9s} "
           f"{'GFLOP/s':>9s} {'GB/s':>8s} {'F/B':>7s}")
    rows = [hdr, "-" * len(hdr)]
    for kind, row in payload["results"].items():
        for kern, c in row.items():
            rows.append(
                f"{kind:10s} {kern:12s} {c['time_s'] * 1e3:9.2f} "
                f"{c['achieved_gflops_s']:9.2f} "
                f"{c['achieved_gbytes_s']:8.2f} "
                f"{c['intensity_flop_per_byte']:7.1f}")
    return "\n".join(rows)


def share_table(payload: dict) -> str:
    """Each cell's share of the H100's peaks and its captured plan."""
    hdr = (f"{'index':10s} {'kernel':12s} {'of HBM':>8s} {'of fp32':>8s} "
           f"{'plan_ms':>9s} {'launches':>8s}  plan")
    rows = [hdr, "-" * len(hdr)]
    for kind, row in payload["results"].items():
        for kern, c in row.items():
            plan_ms = c.get("plan_device_us", float("nan")) / 1e3
            rows.append(
                f"{kind:10s} {kern:12s} {c['peak_share_bytes']:8.2e} "
                f"{c['peak_share_flops']:8.2e} {plan_ms:9.3f} "
                f"{c.get('plan_launches', 0):8.0f}  "
                f"{c.get('plan_sig', '-')}")
    return "\n".join(rows)


def sweep_table(sweep: dict) -> str:
    hdr = f"{'tile':14s} " + " ".join(
        f"{kind + ' ms':>12s}" for kind in sweep["config"]["kinds"]) + \
        f" {'total ms':>10s} {'bit_equal':>9s}"
    rows = [hdr, "-" * len(hdr)]
    for tile, ts in sweep["totals_s"].items():
        per = [sweep["cells"][f"{kind}.{tile}"]
               for kind in sweep["config"]["kinds"]]
        rows.append(f"{tile:14s} " + " ".join(
            f"{c['time_s'] * 1e3:12.3f}" for c in per)
            + f" {sum(ts) / len(ts) * 1e3:10.3f}"
            f" {str(all(c['bit_equal'] for c in per)):>9s}")
    return "\n".join(rows)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spatial", action="store_true",
                    help="run the spatial-kernel roofline sweep")
    ap.add_argument("--kinds", default=",".join(SPATIAL_KINDS))
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--nq", type=int, default=256)
    ap.add_argument("--sweep-nq", type=int, default=64,
                    help="queries of each tile-sweep call")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--dist", default="uniform")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--json", nargs="?", const=DEFAULT_JSON, default=None,
                    metavar="PATH", help="run the spatial sweep and "
                    f"write its payload (default {DEFAULT_JSON})")
    ap.add_argument("--block-sweep", action="store_true",
                    help="sweep the frontier kernel's (block_q, block_p) "
                    "tiles; lands in the --json payload under "
                    "'block_sweep'")
    args = ap.parse_args()
    if not (args.spatial or args.json or args.block_sweep):
        ap.error("nothing to do: pass --spatial, --json or --block-sweep "
                 "(the LM dry-run tables are not ported)")
    payload: dict = {}
    kinds = tuple(args.kinds.split(","))
    if args.spatial or args.json:
        print(f"== spatial-kernel roofline (n={args.n}, nq={args.nq}, "
              f"k={args.k}, {args.dist}) ==")
        payload = spatial_sweep(kinds=kinds, n=args.n, nq=args.nq, k=args.k,
                                dist=args.dist, device=args.device)
        print(spatial_table(payload))
        print(share_table(payload))
    if args.block_sweep:
        print(f"== frontier tile sweep (n={args.n}, nq={args.sweep_nq}, "
              f"k={args.k}, {args.dist}) ==")
        bs = block_sweep(kinds=kinds, n=args.n, nq=args.sweep_nq, k=args.k,
                         dist=args.dist, device=args.device)
        print(sweep_table(bs))
        payload["block_sweep"] = bs
    if args.json:
        common.write_json(args.json, payload, "spatial-kernel roofline")


if __name__ == "__main__":
    main()
