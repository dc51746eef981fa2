"""Benchmark driver of the port: one section per paper figure + the
spatial roofline, on ``repro_torch``.

Counterpart of ``benchmarks/run.py``, with the same sections. The
default size is the card's, 10^7 points (``--quick``: 10^6); ``--n``
overrides. Query counts are the figures' own (500 for fig3 and fig4,
200 for fig5, 300 for fig9, 256 for the roofline); ``--reps`` cuts the
timed reps of every section. Sizes per section: fig3, fig4, fig5, fig10
and the roofline at ``n`` 2D points; fig9 at ``n`` 3D points.

Port-only options:

* ``--device`` -- where the indexes live (default: the card);
* ``--dists`` -- fig3's distributions (default all three);
* ``--block-sweep`` -- the frontier kernel's tile sweep after the
  roofline (``--sweep-nq`` queries a call);
* ``--json DIR`` -- each section's payload as ``DIR/<figure>.json`` (the
  shapes of each figure's own ``--json``; fig4 then sweeps the forced
  routes too);
* ``--details PATH`` -- every section's ``details`` (live sizes and the
  sizes the updates imply, kernel launches by op, the sampled queries'
  answers and the live slice of the generator's points), as one JSON
  file for a checker.

Run:  python -m benchmarks.port.run                    # the card, 10^7
      python -m benchmarks.port.run --quick --skip fig9
      python -m benchmarks.port.run --n 4000 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import time

from . import (common, fig3_grid, fig4_knn, fig5_range, fig9_3d, fig10_batch,
               roofline)

SECTIONS = ("fig3", "fig4", "fig5", "fig10", "fig9", "roofline")


def section(title):
    print(f"\n{'=' * 72}\n== {title}\n{'=' * 72}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help=f"n = {common.QUICK_N:,}")
    ap.add_argument("--n", type=int, default=None,
                    help=f"points (default {common.CARD_N:,})")
    ap.add_argument("--skip", default="", help="comma list of sections "
                    f"from {SECTIONS}")
    ap.add_argument("--dists", default=",".join(fig3_grid.DISTS),
                    help="fig3's distributions")
    ap.add_argument("--reps", type=int, default=None,
                    help="timed reps of every section (default 3)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--block-sweep", action="store_true",
                    help="also sweep the frontier kernel's tiles")
    ap.add_argument("--sweep-nq", type=int, default=64)
    ap.add_argument("--json", default=None, metavar="DIR",
                    help="write each section's payload under DIR")
    ap.add_argument("--details", default=None, metavar="PATH",
                    help="write every section's details as JSON")
    args = ap.parse_args(argv)
    n = args.n or (common.QUICK_N if args.quick else common.CARD_N)
    skip = set(args.skip.split(",")) if args.skip else set()
    if args.reps:
        common.TIMING["reps"] = args.reps
    dev = args.device
    details: dict = {}
    sections_s: dict = {}
    t_start = time.time()

    def emit(name, payload):
        if args.json:
            common.write_json(os.path.join(args.json, f"{name}.json"),
                              payload, name)

    def slim(det):
        """A section's details without the sampled answers."""
        return {key: {k: v for k, v in d.items()
                      if k in ("sizes", "launches", "peak_bytes")}
                for key, d in det.items()}

    def timed_section(name, fn):
        t0 = time.time()
        fn()
        sections_s[name] = time.time() - t0
        print(f"[{name}: {sections_s[name]:.1f}s]", flush=True)

    if "fig3" not in skip:
        dists = tuple(args.dists.split(","))
        section(f"Fig. 3 -- build/update/query grid (n={n}, {dists})")

        def fig3():
            det = details.setdefault("fig3", {})
            print(common.fmt_row("dist/index", fig3_grid.HEADER))
            out = fig3_grid.run(n=n, dists=dists, device=dev, details=det)
            checks = fig3_grid.validate(out)
            print("\n-- paper-claim validation --")
            print("\n".join(fig3_grid.claim_lines(checks)))
            det["_validate"] = [[c, v, bool(ok)] for c, v, ok in checks]
            p = fig3_grid.payload(out, n, 500, dists, checks, dev)
            emit("fig3_grid", {**p, "details": slim(
                {k: v for k, v in det.items() if k != "_validate"})})
        timed_section("fig3", fig3)

    if "fig4" not in skip:
        section(f"Fig. 4 -- kNN vs k (n={n}, varden)")

        def fig4():
            det = details.setdefault("fig4", {})
            impls = fig4_knn.IMPLS if args.json else ("auto",)
            print(common.fmt_row("index",
                                 [f"InD k={k}" for k in fig4_knn.KS]
                                 + [f"OOD k={k}" for k in fig4_knn.KS]))
            out = fig4_knn.run(n=n, device=dev, details=det, impls=impls)
            emit("fig4_knn", {**fig4_knn.payload(out, n, 500, "varden",
                                                 impls, dev),
                              "details": slim(det)})
        timed_section("fig4", fig4)

    if "fig5" not in skip:
        section(f"Fig. 5 -- range-list vs output size (n={n})")

        def fig5():
            det = details.setdefault("fig5", {})
            print(common.fmt_row("index",
                                 [f"t s={s}" for s in fig5_range.SIDES]
                                 + [f"out s={s}" for s in fig5_range.SIDES]))
            out = fig5_range.run(n=n, device=dev, details=det)
            emit("fig5_range", {**fig5_range.payload(out, n, 200, "uniform",
                                                     dev),
                                "details": slim(det)})
        timed_section("fig5", fig5)

    if "fig10" not in skip:
        section(f"Fig. 10 -- single-batch update size sweep (n={n})")

        def fig10():
            det = details.setdefault("fig10", {})
            print(common.fmt_row("index",
                                 [f"ins {r}" for r in fig10_batch.RATIOS]
                                 + [f"del {r}" for r in fig10_batch.RATIOS]))
            out = fig10_batch.run(n=n, device=dev, details=det)
            emit("fig10_batch", {**fig10_batch.payload(out, n, "uniform",
                                                       dev),
                                 "details": slim(det)})
        timed_section("fig10", fig10)

    if "fig9" not in skip:
        section(f"Fig. 9 -- 3D datasets (n={n})")

        def fig9():
            det = details.setdefault("fig9", {})
            print(common.fmt_row("dist/index", fig9_3d.HEADER))
            out = fig9_3d.run(n=n, device=dev, details=det)
            emit("fig9_3d", {**fig9_3d.payload(out, n, 300, dev),
                             "details": slim(det)})
        timed_section("fig9", fig9)

    if "roofline" not in skip:
        section(f"Roofline -- spatial kernels (n={n})")

        def roof():
            payload = roofline.spatial_sweep(n=n, verbose=False, device=dev)
            print(roofline.spatial_table(payload))
            print(roofline.share_table(payload))
            details["roofline"] = {
                kind: {kern: {key: c.get(key) for key in (
                    "plan_sig", "plan_device_us", "plan_launches",
                    "plan_kernels")} for kern, c in row.items()}
                for kind, row in payload["results"].items()}
            if args.block_sweep:
                print(f"-- frontier tile sweep (nq={args.sweep_nq}) --")
                bs = roofline.block_sweep(n=n, nq=args.sweep_nq, device=dev)
                print(roofline.sweep_table(bs))
                payload["block_sweep"] = bs
                details["block_sweep"] = {
                    key: bs[key] for key in ("all_bit_equal", "chosen",
                                             "totals_s", "refused")}
            emit("roofline", payload)
        timed_section("roofline", roof)

    total = time.time() - t_start
    if args.details:
        os.makedirs(os.path.dirname(args.details) or ".", exist_ok=True)
        with open(args.details, "w") as f:
            json.dump({"n": n, "reps": common.TIMING["reps"],
                       "device": common.device_name(dev),
                       "sections_s": sections_s, "total_s": total,
                       **details}, f)
        print(f"wrote details -> {args.details}")
    print(f"\ntotal benchmark time: {total:,.0f}s")


if __name__ == "__main__":
    main()
