"""The frontier walk's reference arithmetic.

Counterpart of ``repro/kernels/frontier/ref.py``. The reference's jnp
walk is the port's plain version, which lives beside the kernel in
``kernel.py`` (:func:`kernel.knn_frontier_plain`); both it and the CUDA
kernel score tiles with :func:`direct_d2` and merge with
:func:`merge_topk`, re-exported here so the walk's arithmetic has one
home.
"""

from __future__ import annotations

from ..knn.ref import BIG, direct_d2, merge_topk  # noqa: F401
from .kernel import knn_frontier_plain  # noqa: F401
