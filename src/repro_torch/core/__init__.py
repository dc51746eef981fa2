"""The port's spatial indexes: the P-Orth tree, the SPaC-tree family and
the kd / Zd baselines behind the Index API.

Counterpart of ``repro/core``::

    from repro_torch.core import make_index
    idx = make_index("spac-h", points, phi=32)   # device=None: the card
    idx = idx.insert(batch).delete(stale)        # functional, auto-capacity
    d2, ids = idx.knn(queries, k=10)             # exact, batched
    counts = idx.range_count(lo, hi)             # exact, auto-sized

Modules: ``sfc`` (Morton / Hilbert codes in int64), ``leafstore`` (leaf
rows), ``porth`` (the P-Orth tree), ``spac`` (the SPaC-tree),
``baselines`` (the kd-tree and Zd-tree rebuild baselines),
``queries`` (chunked kNN and range queries), ``engine`` (the
exact-by-default planner that routes kNN to the CUDA kernels) and
``index`` (registry and facade).
"""

from . import (baselines, engine, index, leafstore, porth,  # noqa: F401
               queries, sfc, spac)
from .engine import QueryEngine  # noqa: F401
from .index import (BACKENDS, Backend, SpatialIndex,  # noqa: F401
                    capacity_for, get_backend, make_index, register_backend)

__all__ = [
    "BACKENDS", "Backend", "QueryEngine", "SpatialIndex", "baselines",
    "capacity_for", "engine", "get_backend", "index", "leafstore",
    "make_index", "porth", "queries", "register_backend", "sfc", "spac",
]
