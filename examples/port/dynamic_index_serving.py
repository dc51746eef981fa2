"""End-to-end example on the PyTorch/CUDA port: the versioned serving
runtime under live load.

Counterpart of ``examples/dynamic_index_serving.py`` on ``repro_torch``.
Per epoch the example (1) snapshots the current version, (2)
*dispatches* the epoch's delete+insert without waiting (the updates are
queued on the card), (3) answers a stream of single-query requests
against the snapshot through the :class:`MicroBatcher` (coalesced into
pow2-padded batches), and (4) ``commit()``s -- the only barrier, whose
wall time is the update stall the queries failed to hide.

    PYTHONPATH=src python examples/port/dynamic_index_serving.py \\
        [--n 200000] [--scenario moving-objects] [--kind spac-h] \\
        [--device cpu]
"""

import argparse
import time

import torch

from repro_torch.core import queries
from repro_torch.data import points as gen
from repro_torch.device import resolve_device
from repro_torch.serving import (LatencyRecorder, MicroBatcher,
                                 SpatialServer)


def wait(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--scenario", default="uniform",
                    choices=list(gen.SCENARIOS))
    ap.add_argument("--kind", default="spac-h")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    epochs = args.warmup + args.epochs
    trace = gen.make_trace(args.scenario, n=args.n,
                           batch=args.n // (2 * epochs), steps=epochs)
    # the trace goes to the device in bulk: an update of host memory
    # would be a synchronising copy on the dispatch path
    steps = [(torch.as_tensor(s.delete, device=dev),
              torch.as_tensor(s.insert, device=dev)) for s in trace.steps]
    t0 = time.time()
    # capacity sized for the trace's peak live points up front, so the
    # serving loop never hits the grow->retry->compact ladder (and the
    # server's deferred overflow check never replays)
    srv = SpatialServer.build(args.kind, trace.bootstrap, phi=32,
                              capacity_points=trace.max_live, window=4,
                              device=dev)
    wait(dev)
    print(f"bootstrap build on {dev}: {trace.bootstrap.shape[0]} pts "
          f"in {time.time() - t0:.2f}s")

    qpts = gen.uniform(9, args.queries, 2)
    box_lo, box_hi = gen.query_boxes(10, args.queries, 2,
                                     gen.DEFAULT_HI // 64)

    rec = LatencyRecorder()
    batcher = MicroBatcher(max_batch=args.queries, max_delay_s=0.05)
    for e, (dele, ins) in enumerate(steps):
        if e == args.warmup:
            rec.reset()   # drop kernel builds + engine bucket escalation
        snap = srv.snapshot()            # pre-epoch version, isolated
        batcher.target = snap
        with rec.timer("delete", dele.shape[0]):
            srv.delete(dele)             # dispatch
        with rec.timer("insert", ins.shape[0]):
            srv.insert(ins)              # dispatch
        t1 = time.perf_counter()
        tickets = [batcher.submit_knn(qpts[i], args.k)
                   for i in range(args.queries)]
        [t.result() for t in tickets]
        wait(dev)
        rec.record("knn", time.perf_counter() - t1, args.queries)
        t1 = time.perf_counter()
        tickets = [batcher.submit_range_count(box_lo[i], box_hi[i])
                   for i in range(args.queries)]
        [t.result() for t in tickets]
        wait(dev)
        rec.record("range", time.perf_counter() - t1, args.queries)
        with rec.timer("commit"):        # exposed update stall
            srv.commit()

    size = len(srv.head_index)
    print(f"[{args.scenario}/{args.kind}] served {args.epochs} epochs "
          f"(+{args.warmup} warmup), final size {size}, "
          f"head version {srv.head_version}")
    assert size == trace.final_size, (size, trace.final_size)
    lat = rec.latency_summary()
    for op in ("insert", "delete", "knn", "range", "commit"):
        s = lat[op]
        print(f"  {op:7s}: p50 {s['p50_ms']:8.2f}ms  "
              f"p95 {s['p95_ms']:8.2f}ms  p99 {s['p99_ms']:8.2f}ms")
    thr = rec.throughput(("knn", "range", "insert", "delete"))
    print(f"  sustained: {thr['knn'] + thr['range']:,.0f} q/s, "
          f"{thr['insert'] + thr['delete']:,.0f} update-pts/s "
          f"(wall {rec.wall_s:.2f}s)")

    # correctness spot-check against brute force on the final state
    idx = srv.head_index
    flat_pts, flat_ok = queries.flatten_view(idx.view())
    live = flat_pts[flat_ok].float()
    q = torch.as_tensor(qpts[:8], device=dev).float()
    d2, _ = idx.knn(q, args.k)
    diff = live[None] - q[:, None]
    bf = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1])
    bf = torch.topk(bf, args.k, dim=1, largest=False).values
    assert torch.equal(d2, bf), "kNN mismatch!"
    print("  spot-check vs brute force: OK")


if __name__ == "__main__":
    main()
