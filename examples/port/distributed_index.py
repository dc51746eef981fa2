"""The paper's index sharded over a mesh, behind the facade, on the
PyTorch/CUDA port.

Counterpart of ``examples/distributed_index.py``: ``make_index(kind,
pts, mesh=mesh)`` returns a ``DistributedIndex`` with the same surface
as the local facade: SFC-range partitioning with sampled splitters, one
all-to-all per batch update, fan-out/merge kNN. The mesh is 8 lanes on
one device (``simulate_mesh``: the card by default). A mesh of several
cards (``make_mesh``) is untested on cards (ROADMAP queue 1 item 6).

    PYTHONPATH=src python examples/port/distributed_index.py              # card
    PYTHONPATH=src python examples/port/distributed_index.py --device cpu
"""

import argparse
import time

import torch

from repro_torch.configs import platform
from repro_torch.core import make_index
from repro_torch.data import points as gen


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16_384)
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device of the lanes (default: the card)")
    args = ap.parse_args()
    mesh = platform.simulate_mesh(args.lanes, device=args.device)

    pts = gen.uniform(0, args.n, 2)                  # (n, 2) int32, numpy
    t0 = time.time()
    idx = make_index("spac-h", pts, mesh=mesh, phi=32)
    idx.block_until_ready()
    print(f"built over {mesh.shape['data']} shards on {idx.device} in "
          f"{time.time() - t0:.2f}s; size={len(idx)}, "
          f"dropped={int(idx.dropped)}, "
          f"points by shard={idx.shard_sizes().tolist()}")

    batch = gen.uniform(1, 2_048, 2)
    t0 = time.time()
    idx = idx.insert(batch).block_until_ready()
    print(f"all-to-all batch insert of {batch.shape[0]}: "
          f"{time.time() - t0:.2f}s; size={len(idx)}")

    qs = gen.uniform(2, 64, 2)
    d2, nbrs, ok = idx.knn(qs, 10)
    # exactness: compare one query against brute force
    allp = torch.cat([torch.as_tensor(pts), torch.as_tensor(batch)]).float()
    diff = allp - torch.as_tensor(qs[0]).float()
    bf = torch.sort((diff * diff).sum(-1)).values[:10]
    assert torch.equal(d2[0].cpu(), bf), "distributed kNN mismatch"
    print(f"distributed kNN exact across shards "
          f"(d2[0,0]={float(d2[0, 0]):.1f})")

    lo = torch.tensor([[0, 0]], dtype=torch.int32)
    hi = torch.tensor([[1 << 19, 1 << 19]], dtype=torch.int32)
    cnt = idx.range_count(lo, hi)   # exact: the engine escalates per shard
    want = int(((allp >= lo.float()) & (allp <= hi.float())).all(-1).sum())
    assert int(cnt[0]) == want, (int(cnt[0]), want)
    print(f"distributed range count: {int(cnt[0])}")
    print("distributed index OK")


if __name__ == "__main__":
    main()
