"""Paper Fig. 10 on the port: single-batch insert/delete time vs batch
size.

Counterpart of ``benchmarks/fig10_batch.py``, with its sizes, procedure
and payload keys: one index of ``n`` points per backend, then one batch
insert of 0.1%, 1% and 10% of ``n`` (fresh points) and one batch delete
of as many of its points, each timed on the built index (updates are
functional, so every rep starts from the same tree). ``--json`` records
update throughput (points/s) per (backend, op, batch ratio) under
``results/port/``.

Run:  python -m benchmarks.port.fig10_batch --n 10000000
      python -m benchmarks.port.fig10_batch --n 10000000 --json
      python -m benchmarks.port.fig10_batch --n 50000 --device cpu
"""

from __future__ import annotations

import argparse

from . import common

RATIOS = (0.001, 0.01, 0.1)


def run(n=100_000, dist="uniform", indexes=None, phi=32, verbose=True,
        device=None, details=None):
    names = indexes or ["porth", "spac-h", "spac-z", "kd"]
    pts = common.on_device(common.points_for(dist, n), device)
    extra = common.on_device(common.points_for(dist, int(n * 0.1), seed=5),
                             device)
    common.peak_bytes(reset=True)
    out = {}
    for name in names:
        det = {"launches": {}, "sizes": {}} if details is not None else None
        launches = det["launches"] if det else None
        with common.tally(launches, "build"):
            idx = common.build_index(name, pts, phi=phi,
                                     capacity_points=int(n * 1.2),
                                     device=device)
        rec = {}
        for r in RATIOS:
            m = max(int(n * r), 64)
            with common.tally(launches, "insert"):
                rec[f"ins_{r}"], ins = common.timed(idx.insert, extra[:m])
            with common.tally(launches, "delete"):
                rec[f"del_{r}"], dele = common.timed(idx.delete, pts[:m])
            if det is not None:   # extra holds 10% of n: m may exceed it
                det["sizes"][f"ins_{r}"] = common.size_detail(
                    ins, n + extra[:m].shape[0])
                det["sizes"][f"del_{r}"] = common.size_detail(dele, n - m)
            del ins, dele
        if det is not None:
            det["sizes"]["build"] = common.size_detail(idx, n)
            det["peak_bytes"] = common.peak_bytes(reset=True)
            details[name] = det
        del idx
        common.release()
        out[name] = rec
        if verbose:
            print(common.fmt_row(name, [rec[f"ins_{r}"] for r in RATIOS]
                                 + [rec[f"del_{r}"] for r in RATIOS]),
                  flush=True)
    return out


def throughput_records(out, n: int):
    """Flatten run() output to update points/s per (backend, op,
    ratio) -- the fig4_knn.py --json shape."""
    return {name: {key: max(int(n * r), 64) / rec[key]
                   for r in RATIOS
                   for key in (f"ins_{r}", f"del_{r}")}
            for name, rec in out.items()}


def payload(out, n: int, dist: str, device=None) -> dict:
    return dict(n=n, dist=dist, update_pts_per_s=throughput_records(out, n),
                device=common.device_name(device))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--dist", default="uniform")
    ap.add_argument("--indexes", default=None,
                    help="comma list (default: porth,spac-h,spac-z,kd)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--json", nargs="?",
                    const=f"{common.RESULTS}/fig10_batch.json", default=None,
                    metavar="PATH",
                    help="write update points/s per (backend, op, ratio)")
    args = ap.parse_args()
    names = args.indexes.split(",") if args.indexes else None
    print(common.fmt_row("index", [f"ins {r}" for r in RATIOS]
                         + [f"del {r}" for r in RATIOS]))
    out = run(n=args.n, dist=args.dist, indexes=names, device=args.device)
    if args.json:
        common.write_json(args.json, payload(out, args.n, args.dist,
                                             args.device),
                          "update points/s per (backend, op, ratio)")


if __name__ == "__main__":
    main()
