"""Paper Fig. 5 on the port: range-list time vs output size.

Counterpart of ``benchmarks/fig5_range.py``, with its sizes, procedure
and payload keys: per backend and box side, the time of one batched
``range_list`` over boxes from the port's :func:`query_boxes` (seeded by
the side, as the reference seeds its boxes) and the mean output size.
``--json`` records q/s and mean output size per (backend, box side)
under ``results/port/``.

Run:  python -m benchmarks.port.fig5_range --n 10000000
      python -m benchmarks.port.fig5_range --n 10000000 --json
      python -m benchmarks.port.fig5_range --n 20000 --device cpu
"""

from __future__ import annotations

import argparse

from repro_torch.data.points import query_boxes

from . import common

SIDES = (2**10, 2**12, 2**14)    # of a 2^20 domain


def run(n=50_000, nq=200, dist="uniform", indexes=None, phi=32,
        verbose=True, device=None, details=None):
    names = indexes or ["porth", "spac-h", "spac-z", "kd", "zd"]
    pts = common.on_device(common.points_for(dist, n), device)
    live = common.live_spec(dist, n, n)
    boxes = {side: query_boxes(side, nq, 2, side) for side in SIDES}
    common.peak_bytes(reset=True)
    out = {}
    for name in names:
        det = {"launches": {}, "range_list": {}} \
            if details is not None else None
        launches = det["launches"] if det else None
        with common.tally(launches, "build"):
            idx = common.build_index(name, pts, phi=phi, capacity_points=n,
                                     device=device)
        rec = {}
        for side in SIDES:
            lo, hi = boxes[side]
            lo_d, hi_d = common.on_device(lo, device), \
                common.on_device(hi, device)
            # exact by construction: the engine sizes its own buffers
            with common.tally(launches, "range_list"):
                t, (ids, cnt) = common.timed(idx.range_list, lo_d, hi_d)
            rec[f"side_{side}"] = t
            rec[f"out_{side}"] = float(cnt.float().mean())
            if det is not None:
                det["range_list"][f"side_{side}"] = common.range_detail(
                    idx, lo, hi, cnt, live, ids=ids)
        if det is not None:
            det["sizes"] = {"build": common.size_detail(idx, n)}
            det["peak_bytes"] = common.peak_bytes(reset=True)
            details[name] = det
        del idx
        common.release()
        out[name] = rec
        if verbose:
            print(common.fmt_row(
                name, [rec[f"side_{s}"] for s in SIDES]
                + [rec[f"out_{s}"] for s in SIDES]), flush=True)
    return out


def qps_records(out, nq: int):
    """Flatten run() output to q/s + mean output size per (backend,
    side) -- the fig4_knn.py --json shape."""
    return {name: {f"side_{s}": {"qps": nq / rec[f"side_{s}"],
                                 "avg_out": rec[f"out_{s}"]}
                   for s in SIDES}
            for name, rec in out.items()}


def payload(out, n: int, nq: int, dist: str, device=None) -> dict:
    return dict(n=n, nq=nq, dist=dist, qps=qps_records(out, nq),
                device=common.device_name(device))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--nq", type=int, default=200)
    ap.add_argument("--dist", default="uniform")
    ap.add_argument("--indexes", default=None,
                    help="comma list (default: porth,spac-h,spac-z,kd,zd)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--json", nargs="?",
                    const=f"{common.RESULTS}/fig5_range.json", default=None,
                    metavar="PATH",
                    help="write q/s + avg output per (backend, side)")
    args = ap.parse_args()
    names = args.indexes.split(",") if args.indexes else None
    print(common.fmt_row("index", [f"t side={s}" for s in SIDES]
                         + [f"avg out s={s}" for s in SIDES]))
    out = run(n=args.n, nq=args.nq, dist=args.dist, indexes=names,
              device=args.device)
    if args.json:
        common.write_json(args.json, payload(out, args.n, args.nq,
                                             args.dist, args.device),
                          "q/s per (backend, side)")


if __name__ == "__main__":
    main()
