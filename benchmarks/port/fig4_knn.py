"""Paper Fig. 4 on the port: k-NN time vs k (1, 10, 100), InD + OOD,
after incremental insertion.

Counterpart of ``benchmarks/fig4_knn.py``, with its sizes, procedure and
payload keys. ``--json`` additionally sweeps the engine's forced routes
and records q/s per (backend, impl) under ``results/port/``. The
reference's ``flat`` column (the brute-force scan) is the port's
``cuda`` route (:data:`IMPL_OF`); the payload keeps the reference's
names (``flat_ind_k10``, ...), so payloads compare key for key.
``frontier`` is the chunked traversal in both.

Run:  python -m benchmarks.port.fig4_knn --n 10000000
      python -m benchmarks.port.fig4_knn --n 10000000 --json
      python -m benchmarks.port.fig4_knn --n 20000 --device cpu
"""

from __future__ import annotations

import argparse

from . import common

KS = (1, 10, 100)
IMPLS = ("auto", "frontier", "flat")
# the reference's route names -> the port's spelling of the same route
IMPL_OF = {"auto": "auto", "frontier": "frontier", "flat": "cuda"}


def _grown(name, dist, n, batch_ratio, phi, device, launches):
    """Half the points built, the other half inserted in batches of
    ``batch_ratio * n``; returns (index, live points)."""
    pts = common.on_device(common.points_for(dist, n), device)
    m = max(int(n * batch_ratio), 64)
    with common.tally(launches, "build"):
        idx = common.build_index(name, pts[: n // 2], phi=phi,
                                 capacity_points=n, device=device)
    steps = (n // 2) // m
    with common.tally(launches, "insert"):
        for b in range(steps):
            idx = idx.insert(pts[n // 2 + b * m: n // 2 + (b + 1) * m])
    return idx, n // 2 + steps * m


def run(n=50_000, nq=500, dist="varden", indexes=None, phi=32,
        batch_ratio=0.01, verbose=True, impls=("auto",), device=None,
        details=None):
    names = indexes or ["porth", "spac-h", "spac-z", "kd", "zd"]
    ind_h, ood_h = common.knn_queries(dist, nq)
    ind_q, ood_q = (common.on_device(q, device) for q in (ind_h, ood_h))
    common.peak_bytes(reset=True)
    out = {}
    for name in names:
        det = {"launches": {}, "sizes": {}, "knn": {}} \
            if details is not None else None
        launches = det["launches"] if det else None
        idx, live = _grown(name, dist, n, batch_ratio, phi, device,
                           launches)
        spec = common.live_spec(dist, n, live)
        rec = {}
        for impl in impls:
            tag = "" if impl == "auto" else f"{impl}_"
            op = "knn" if impl == "auto" else f"knn_{impl}"
            for k in KS:
                for side, q, qh in (("ind", ind_q, ind_h),
                                    ("ood", ood_q, ood_h)):
                    with common.tally(launches, op):
                        rec[f"{tag}{side}_k{k}"], got = common.timed(
                            idx.knn, q, k, impl=IMPL_OF[impl])
                    if det is not None:
                        det["knn"][f"{tag}{side}_k{k}"] = common.knn_detail(
                            qh, got, k, spec)
        if det is not None:
            det["sizes"] = {"grown": common.size_detail(idx, live)}
            det["peak_bytes"] = common.peak_bytes(reset=True)
            details[name] = det
        del idx
        common.release()
        out[name] = rec
        if verbose:
            print(common.fmt_row(name, [rec[f"ind_k{k}"] for k in KS]
                                 + [rec[f"ood_k{k}"] for k in KS]),
                  flush=True)
    return out


def qps_records(out, nq: int, impls=IMPLS):
    """Flatten run() output to q/s per (backend, impl, k, workload)."""
    recs = {}
    for name, rec in out.items():
        for impl in impls:
            tag = "" if impl == "auto" else f"{impl}_"
            recs.setdefault(name, {})[impl] = {
                f"{side}_k{k}": nq / rec[f"{tag}{side}_k{k}"]
                for side in ("ind", "ood") for k in KS
                if rec.get(f"{tag}{side}_k{k}")}
    return recs


def payload(out, n: int, nq: int, dist: str, impls=IMPLS,
            device=None) -> dict:
    """The ``--json`` payload: the reference's keys plus the device."""
    return dict(n=n, nq=nq, dist=dist, qps=qps_records(out, nq, impls),
                device=common.device_name(device))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--nq", type=int, default=500)
    ap.add_argument("--dist", default="varden")
    ap.add_argument("--indexes", default=None,
                    help="comma list (default: porth,spac-h,spac-z,kd,zd)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--json", nargs="?",
                    const=f"{common.RESULTS}/fig4_knn.json", default=None,
                    metavar="PATH",
                    help="also sweep forced impls and write q/s per "
                         "(backend, impl) as json")
    args = ap.parse_args()
    impls = IMPLS if args.json else ("auto",)
    names = args.indexes.split(",") if args.indexes else None
    print(common.fmt_row("index", [f"InD k={k}" for k in KS]
                         + [f"OOD k={k}" for k in KS]))
    out = run(n=args.n, nq=args.nq, dist=args.dist, indexes=names,
              impls=impls, device=args.device)
    if args.json:
        common.write_json(args.json, payload(out, args.n, args.nq,
                                             args.dist, impls, args.device),
                          "q/s per (backend, impl)")


if __name__ == "__main__":
    main()
