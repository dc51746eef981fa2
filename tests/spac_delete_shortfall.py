"""Cross-package check, run by hand (it is not a test: at the sizes where
it shows it takes minutes): fig3's incremental sequence -- half of
``n`` points built, the rest inserted in batches of 1%, then 4 batches
deleted -- through the port and through the JAX reference on the same
numpy arrays, printing each package's live count beside the count the
updates imply. The spac family's deletes leave points behind at scale
in both packages (ROADMAP queue 3).

    PYTHONPATH=src:. python tests/spac_delete_shortfall.py --n 4000000 --dist varden
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from benchmarks.port import common
from repro.core import make_index as reference_make_index


def sequence(make, pts: np.ndarray, kind: str, m: int) -> int:
    n = pts.shape[0]
    idx = make(kind, pts[: n // 2], phi=32, capacity_points=n,
               coord_bits=common.COORD_BITS, max_overflow_rows=max(64, m))
    steps = (n // 2) // m
    for b in range(steps):
        idx = idx.insert(pts[n // 2 + b * m: n // 2 + (b + 1) * m])
    for b in range(min(steps, 4)):
        idx = idx.delete(pts[n // 2 + b * m: n // 2 + (b + 1) * m])
    return len(idx)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4_000_000)
    ap.add_argument("--dist", default="varden")
    ap.add_argument("--kind", default="spac-h")
    args = ap.parse_args()
    pts = common.points_for(args.dist, args.n)
    m = max(int(args.n * 0.01), 64)
    steps = (args.n // 2) // m
    want = args.n // 2 + steps * m - min(steps, 4) * m
    torch.set_num_threads(4)
    for name, make in (
            ("port", lambda *a, **kw: common.make_index(*a, device="cpu",
                                                         **kw)),
            ("reference", reference_make_index)):
        t0 = time.perf_counter()
        got = sequence(make, pts, args.kind, m)
        print(f"{name}: {got} live, the updates imply {want} "
              f"({got - want:+d}; {time.perf_counter() - t0:.1f}s)",
              flush=True)


if __name__ == "__main__":
    main()
