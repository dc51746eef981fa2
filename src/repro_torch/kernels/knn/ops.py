"""Impl routing for the flat kNN kernel.

Canonical spellings, shared with the engine and ``kernels/frontier``:

* ``cuda``  -- the CUDA kernel (:func:`kernel.knn_flat`; a CPU tensor
  takes its plain version, the only thing a CPU host can run)
* ``plain`` -- the plain PyTorch version, on any device
"""

from __future__ import annotations

from .kernel import knn_flat, knn_flat_plain

KNN_KERNEL_IMPLS = ("cuda", "plain")


def canonical_impl(impl: str) -> str:
    """Validate an impl spelling; the reference's Pallas spellings name
    TPU kernels the port does not have."""
    if impl not in KNN_KERNEL_IMPLS:
        raise ValueError(f"unknown knn kernel impl {impl!r}; expected one "
                         f"of {KNN_KERNEL_IMPLS}")
    return impl


def knn_bruteforce(queries, points, ok, *, k: int, impl: str = "cuda"):
    """Exact brute-force kNN -> (d2 (Q, k) ascending, idx (Q, k), -1
    padded)."""
    if canonical_impl(impl) == "plain":
        return knn_flat_plain(queries, points, ok, k=k)
    return knn_flat(queries, points, ok, k=k)
