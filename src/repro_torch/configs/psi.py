"""The paper's own workload configurations (Sec. 5 experiment grid).

The port's copy of ``repro/configs/psi.py``: the same frozen dataclass,
fields, defaults and grids. Sizes default to a small host and scale with
the benchmarks' ``--n`` flags (the paper's machine ran n = 1e9 on 112
cores).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PsiWorkload:
    name: str
    dist: str              # uniform | sweepline | varden
    n: int                 # index size
    dim: int = 2
    batch_ratios: tuple = (0.1, 0.01)     # incremental update ratios
    n_queries: int = 500
    knn_k: int = 10
    range_side_frac: float = 1 / 64       # of the coordinate domain
    phi: int = 32                          # leaf wrap (paper: 32-40)


# Fig. 3 grid (2D synthetic); paper: n=1e9, ratios 10%..0.01%
FIG3 = tuple(
    PsiWorkload(f"fig3-{d}", d, n=50_000) for d in
    ("uniform", "sweepline", "varden"))

# Fig. 9 grid (3D synthetic); paper: coordinates in [0, 1e6]
FIG9 = tuple(
    PsiWorkload(f"fig9-{d}", d, n=30_000, dim=3) for d in
    ("uniform", "varden"))

# Fig. 10 single-batch sweep; paper: batches 1e5..1e9 on n=1e9
FIG10 = PsiWorkload("fig10-uniform", "uniform", n=100_000,
                    batch_ratios=(0.001, 0.01, 0.1))

# dynamic service (examples/dynamic_index_serving.py)
SERVICE = PsiWorkload("service", "uniform", n=200_000,
                      batch_ratios=(0.025,))
