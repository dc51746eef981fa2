"""Quickstart on the PyTorch/CUDA port: build a dynamic spatial index,
update it, query it.

Counterpart of ``examples/quickstart.py`` on ``repro_torch``: one facade
(``repro_torch.core.make_index``) fronts every tree family of the paper
-- P-Orth, the SPaC family and the kd/Zd baselines -- with automatic
capacity management, on the card by default.

    PYTHONPATH=src python examples/port/quickstart.py               # card
    PYTHONPATH=src python examples/port/quickstart.py --device cpu
"""

import argparse
import os
import tempfile

import torch

from repro_torch import obs
from repro_torch.core import BACKENDS, make_index
from repro_torch.data import points as gen

ap = argparse.ArgumentParser()
ap.add_argument("--n", type=int, default=20_000)
ap.add_argument("--device", default=None,
                help="torch device (default: the card)")
args = ap.parse_args()
n = args.n

# ---------------------------------------------------------------- build
pts = gen.uniform(0, n, dim=2)                       # (n, 2) int32, numpy
idx = make_index("spac-h", pts, phi=32, device=args.device)  # on the card
print(f"SPaC-H index on {idx.device}: {len(idx)} points in "
      f"{int(idx.num_rows)} leaf "
      # contract: allow[capacity-internals] display-only introspection;
      # nothing here acts on the capacity
      f"rows ({idx.capacity_rows} allocated)")

# --------------------------------------------------------- batch update
batch = gen.uniform(1, 2_000, dim=2)
idx = idx.insert(batch)              # parallel batch insert (auto-grows)
idx = idx.delete(pts[:1_000])        # parallel batch delete
print(f"after +2000/-1000: {len(idx)} points")

# -------------------------------------------------------------- queries
# Queries are exact by default: the engine sizes its own buffers, and
# impl="auto" routes each kNN to the flat brute-force kernel when the
# index fits a flat scan, or to the frontier kernel otherwise (a pruned
# best-first walk over row groups; direct (q - p)^2 distances in fp32).
qpts = gen.uniform(2, 100, dim=2)
d2, nbrs, ok = idx.knn_points(qpts, k=10)            # exact batched kNN
print(f"10-NN of first query: d2={d2[0, :3].tolist()}... -> "
      f"{nbrs[0, 0].tolist()}")

# forcing an impl pins the route: frontier (chunked traversal) |
# cuda-frontier | plain-frontier | cuda (flat kernel) | plain. The
# frontier kernel's tiles come from a sweep:
#   python -m benchmarks.port.roofline --block-sweep --json
d2_fr, _ = idx.knn(qpts, k=10, impl="frontier")      # chunked traversal
d2_fu, _ = idx.knn(qpts, k=10, impl="cuda-frontier")  # frontier kernel
d2_bf, _ = idx.knn(qpts, k=10, impl="plain")         # flat scan (torch)
assert torch.equal(d2_fr, d2_bf) and torch.equal(d2_fu, d2_bf)  # all exact
print("frontier, frontier-kernel and brute-force impls agree")

lo = torch.tensor([[0, 0]], dtype=torch.int32)
hi = torch.tensor([[1 << 18, 1 << 18]], dtype=torch.int32)
cnt = idx.range_count(lo, hi)                        # exact, auto-sized
print(f"range count in [0, 2^18]^2: {int(cnt[0])}")

# ------------------------------------- other backends, same interface
print("registered backends:", ", ".join(sorted(BACKENDS)))
t2 = make_index("porth", pts, phi=32, device=args.device)  # P-Orth tree
t2 = t2.insert(batch).delete(pts[:1_000])    # same update sequence
d2_p, _ = t2.knn(qpts, k=10)
agree = bool(torch.equal(d2_p, d2))
print("P-Orth agrees with SPaC on kNN distances:", agree)
assert agree

# ------------------------------------------------- observability
# Wrap any section in a span to trace it; counters from the engine
# (plan-cache traffic, routes, escalation rounds) land in the same
# recorder. Device values are attached, not read: the one read happens
# at report(), the barrier.
with obs.recording() as rec:
    with obs.span("quickstart.knn", queries=len(qpts)) as sp:
        d2_t, _ = idx.knn(qpts, k=10)
        sp.defer("min_d2", d2_t.min())    # no host sync here
    report = rec.report()                 # <- the barrier: resolves it
print(f"traced knn: {report['spans']['quickstart.knn']['mean']:.2f}ms, "
      f"engine traces so far: {report['counters'].get('engine.trace', 0)}")

trace_path = os.path.join(tempfile.gettempdir(), "quickstart_trace.json")
obs.write_chrome_trace(rec, trace_path)
print(f"wrote {trace_path} -- inspect with: "
      f"python -m repro_torch.obs.view {trace_path} (or load in Perfetto)")

# per-plan costs: what the device did for each plan, captured once
with obs.recording(obs.Recorder(capture_costs=True)) as rec:
    idx.knn(qpts, k=10)
costs = obs.costs.plan_costs(rec.counters)
for sig, c in costs.items():
    print(f"plan {sig}: {c['device_us']:.0f} us on the device, "
          f"{c['launches']:.0f} launches")

# ------------------------------------------- memory + perf drift
# Index memory is nbytes metadata -- shape/dtype arithmetic, no device
# sync -- so it is free to print even on dispatch paths.
print(f"index holds {obs.fmt_bytes(idx.nbytes)} across "
      f"{len(idx):,} live points")
# Perf drift vs the committed baseline (results/port/regress_smoke.json):
#   python -m repro_torch.obs.regress           # local bands, the card
#   python -m repro_torch.obs.regress --ci      # CI bands
# --update rewrites the baseline after an intentional perf change, and
# each run appends results/port/bench/BENCH_n
