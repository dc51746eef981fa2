"""Fused frontier kNN: per query block, walk leaf-row groups in ascending
bbox-lower-bound order with a running top-k and stop at the first bound
above the block's worst k-th best (``kernel.py``: the CUDA kernel and its
plain version; ``prep.py``: grouping, query Morton sort, per-block visit
order; ``ops.py``: routing, un-sort, direct rescore)."""

from .ops import FRONTIER_IMPLS, knn_frontier_impl  # noqa: F401
