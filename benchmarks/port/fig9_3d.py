"""Paper Fig. 9 (appendix E) on the port: 3D synthetic datasets.

Counterpart of ``benchmarks/fig9_3d.py``: the same grid as Fig. 3 but
dim=3 (octree splits for P-Orth, 10-bit/dim Morton/Hilbert codes for
SPaC): per distribution and kind, one build, one insert and one delete
of 1% of the points, and one batched kNN (k=10).

Run:  python -m benchmarks.port.fig9_3d --n 10000000
      python -m benchmarks.port.fig9_3d --n 20000 --device cpu
"""

from __future__ import annotations

import argparse

import torch

from . import common

DISTS_3D = ("uniform", "varden")
# per-kind params for the 3D regime: 10-bit/dim SFC codes on a 2^20
# domain; porth derives lam=2 (octree, 2 levels/round) from dim itself
KINDS_3D = {
    "porth": dict(),
    "spac-h": dict(bits=10, coord_bits=20),
    "spac-z": dict(bits=10, coord_bits=20),
}
HEADER = ["build", "ins 1%", "del 1%", "knn10"]


def run(n=30_000, nq=300, phi=32, verbose=True, dists=DISTS_3D,
        device=None, details=None):
    out = {}
    for dist in dists:
        pts = common.on_device(common.points_for(dist, n, dim=3), device)
        ind_h, _ = common.knn_queries(dist, nq, dim=3)
        ind_q = common.on_device(ind_h, device)
        common.peak_bytes(reset=True)
        for name, params in KINDS_3D.items():
            det = {"launches": {}, "sizes": {}, "knn": {}} \
                if details is not None else None
            launches = det["launches"] if det else None
            rec = {}
            m = max(n // 100, 64)
            with common.tally(launches, "build"):
                rec["build"], idx = common.timed(
                    common.build_index, name, pts, phi=phi,
                    capacity_points=n, device=device, **params)
            with common.tally(launches, "insert"):
                rec["ins"], idx = common.timed(idx.insert, pts[:m])
            if det is not None:
                det["sizes"]["ins"] = common.size_detail(idx, n + m)
            with common.tally(launches, "delete"):
                rec["del"], idx = common.timed(idx.delete, pts[:m])
            if det is not None:
                det["sizes"]["del"] = common.size_detail(
                    idx, n, torch.cat([pts, pts[:m]]), pts[:m])
            with common.tally(launches, "knn"):
                rec["knn"], got = common.timed(idx.knn, ind_q, 10)
            if det is not None:
                det["knn"]["knn"] = common.knn_detail(
                    ind_h, got, 10, common.live_spec(dist, n, n, dim=3))
                det["peak_bytes"] = common.peak_bytes(reset=True)
                details[f"{dist}/{name}"] = det
            del idx
            common.release()
            out[(dist, name)] = rec
            if verbose:
                print(common.fmt_row(f"{dist[:6]}/{name}",
                                     [rec["build"], rec["ins"],
                                      rec["del"], rec["knn"]]),
                      flush=True)
    return out


def payload(out, n: int, nq: int, device=None) -> dict:
    return {"n": n, "nq": nq, "dim": 3, "device": common.device_name(device),
            "params": KINDS_3D,
            "results": {f"{d}/{i}": r for (d, i), r in out.items()}}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=30_000)
    ap.add_argument("--nq", type=int, default=300)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--json", nargs="?",
                    const=f"{common.RESULTS}/fig9_3d.json", default=None,
                    metavar="PATH")
    args = ap.parse_args()
    print(common.fmt_row("dist/index", HEADER))
    out = run(n=args.n, nq=args.nq, device=args.device)
    if args.json:
        common.write_json(args.json, payload(out, args.n, args.nq,
                                             args.device), "fig9 grid")


if __name__ == "__main__":
    main()
