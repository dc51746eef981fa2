"""Paper Fig. 3 on the port: build / incremental insert / incremental
delete / queries, across distributions x indexes.

Counterpart of ``benchmarks/fig3_grid.py``, with its procedure, record
keys and claims. :func:`validate` checks the paper's headline ratios
(Sec. 5.1) on whatever ran:

  * SPaC updates beat the total-order CPAM-style ablation.
  * P-Orth builds beat the Zd-style Morton presort.
  * Space-partitioning kNN is no slower than R-tree (SPaC) kNN.

The paper measured them on a 112-core CPU. On the card a FAIL is a
finding about the port on that hardware, not an error: the run still
exits 0.

Run:  python -m benchmarks.port.fig3_grid --n 10000000
      python -m benchmarks.port.fig3_grid --n 20000 --device cpu
"""

from __future__ import annotations

import argparse
import functools

from repro_torch.data.points import query_boxes

from . import common

DISTS = ("uniform", "sweepline", "varden")
HEADER = ["build", "ins10%", "ins1%", "del10%", "del1%", "knnInD",
          "knnOOD", "rangeC"]


def run(n=50_000, nq=500, ratios=(0.1, 0.01), indexes=None, phi=32,
        verbose=True, knn_k=10, dists=DISTS, device=None, details=None):
    names = indexes or list(common.BENCH_KINDS)
    out = {}
    for dist in dists:
        pts = common.on_device(common.points_for(dist, n), device)
        ind_h, ood_h = common.knn_queries(dist, nq)
        ind_q, ood_q = (common.on_device(q, device) for q in (ind_h, ood_h))
        lo_h, hi_h = query_boxes(3, nq, 2, common.HI // 64)
        lo, hi = common.on_device(lo_h, device), common.on_device(hi_h, device)
        common.peak_bytes(reset=True)
        for name in names:
            det = {"launches": {}, "sizes": {}, "knn": {}, "range_count": {}} \
                if details is not None else None
            launches = det["launches"] if det else None
            build = functools.partial(common.build_index, name, phi=phi,
                                      capacity_points=n, device=device)
            rec = {}
            with common.tally(launches, "build"):
                rec["build"], idx = common.timed(build, pts)
            # incremental insert: half static, half in batches
            for r in ratios:
                m = max(int(n * r), 64)
                with common.tally(launches, "insert"):
                    common.timed_once(idx.insert, pts[:m])   # warm caches
                total = 0.0
                with common.tally(launches, "build"):
                    idx2 = build(pts[: n // 2])
                steps = max((n // 2) // m, 1)
                done = 0
                for b in range(steps):
                    batch = pts[n // 2 + b * m: n // 2 + (b + 1) * m]
                    if batch.shape[0] < m:
                        break
                    with common.tally(launches, "insert"):
                        t, idx2 = common.timed_once(idx2.insert, batch)
                    total += t
                    done += 1
                rec[f"inc_ins_{r}"] = total
                live = n // 2 + done * m
                if det is not None:
                    det["sizes"][f"inc_ins_{r}"] = \
                        common.size_detail(idx2, live)
                if r == ratios[-1]:
                    spec = common.live_spec(dist, n, live)
                    for side, q, qh in (("ind", ind_q, ind_h),
                                        ("ood", ood_q, ood_h)):
                        with common.tally(launches, "knn"):
                            rec[f"knn_{side}"], got = common.timed(
                                idx2.knn, q, knn_k)
                        if det is not None:
                            det["knn"][f"knn_{side}"] = common.knn_detail(
                                qh, got, knn_k, spec)
                    with common.tally(launches, "range_count"):
                        rec["range_cnt"], cnt = common.timed(
                            idx2.range_count, lo, hi)
                    if det is not None:
                        det["range_count"]["range_cnt"] = \
                            common.range_detail(idx2, lo_h, hi_h, cnt, spec)
                # incremental delete at this ratio
                total = 0.0
                if r == ratios[-1]:
                    idx3, base = idx2, live
                else:
                    with common.tally(launches, "build"):
                        idx3, base = build(pts), n
                gone = 0
                for b in range(min(steps, 4)):
                    batch = pts[n // 2 + b * m: n // 2 + (b + 1) * m]
                    if batch.shape[0] < m:
                        break
                    with common.tally(launches, "delete"):
                        t, idx3 = common.timed_once(idx3.delete, batch)
                    total += t
                    gone += m
                rec[f"inc_del_{r}"] = total
                if det is not None:
                    det["sizes"][f"inc_del_{r}"] = common.size_detail(
                        idx3, base - gone, pts[:base],
                        pts[n // 2: n // 2 + gone])
                del idx2, idx3
            del idx
            common.release()
            out[(dist, name)] = rec
            if det is not None:
                det["peak_bytes"] = common.peak_bytes(reset=True)
                details[f"{dist}/{name}"] = det
            if verbose:
                cells = [rec["build"]] + \
                    [rec[f"inc_ins_{r}"] for r in ratios] + \
                    [rec[f"inc_del_{r}"] for r in ratios] + \
                    [rec.get("knn_ind", float("nan")),
                     rec.get("knn_ood", float("nan")),
                     rec.get("range_cnt", float("nan"))]
                print(common.fmt_row(f"{dist[:6]}/{name}", cells),
                      flush=True)
    return out


def validate(out, ratios=(0.1, 0.01)):
    """Check the paper's headline ratios over the distributions that
    ran; returns list of (claim, value, passed)."""
    checks = []
    r = ratios[-1]
    for dist in (d for d in DISTS if any(key[0] == d for key in out)):
        if ("uniform", "cpam-h") in out:
            spac_u = out[(dist, "spac-h")][f"inc_ins_{r}"]
            cpam_u = out[(dist, "cpam-h")][f"inc_ins_{r}"]
            checks.append((f"{dist}: SPaC-H updates faster than "
                           f"total-order CPAM", cpam_u / spac_u,
                           cpam_u / spac_u > 1.0))
        if ("uniform", "zd") in out:
            p = out[(dist, "porth")]["build"]
            z = out[(dist, "zd")]["build"]
            checks.append((f"{dist}: P-Orth build faster than Zd presort",
                           z / p, z / p > 1.0 or dist == "varden"))
        if ("uniform", "kd") in out and (dist, "porth") in out:
            sk = out.get((dist, "spac-h"), {}).get("knn_ind")
            pk = out[(dist, "porth")].get("knn_ind")
            if sk and pk:
                checks.append((f"{dist}: space-partitioning kNN <= R-tree "
                               f"kNN", sk / pk, sk / pk >= 0.8))
    return checks


def claim_lines(checks) -> list:
    return [f"  [{'PASS' if ok else 'FAIL'}] {claim}: {val:.2f}x"
            for claim, val, ok in checks]


def payload(out, n: int, nq: int, dists, checks, device=None) -> dict:
    return {"n": n, "nq": nq, "dists": list(dists),
            "device": common.device_name(device),
            "results": {f"{d}/{i}": r for (d, i), r in out.items()},
            "validate": [{"claim": c, "ratio": v, "passed": bool(ok)}
                         for c, v, ok in checks]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--nq", type=int, default=500)
    ap.add_argument("--indexes", default=None,
                    help="comma list (default: all)")
    ap.add_argument("--dists", default=",".join(DISTS))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--json", nargs="?",
                    const=f"{common.RESULTS}/fig3_grid.json", default=None,
                    metavar="PATH")
    args = ap.parse_args()
    names = args.indexes.split(",") if args.indexes else None
    dists = tuple(args.dists.split(","))
    print(common.fmt_row("dist/index", HEADER))
    out = run(n=args.n, nq=args.nq, indexes=names, dists=dists,
              device=args.device)
    checks = validate(out)
    print("\n-- paper-claim validation --")
    print("\n".join(claim_lines(checks)))
    if args.json:
        common.write_json(args.json, payload(out, args.n, args.nq, dists,
                                             checks, args.device),
                          "fig3 grid and claims")


if __name__ == "__main__":
    main()
