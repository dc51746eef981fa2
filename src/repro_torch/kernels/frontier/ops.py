"""Impl routing for the frontier walk.

Canonical spellings (shared with ``kernels/knn`` and the engine):

* ``cuda``  -- the CUDA kernel (:func:`kernel.knn_frontier`; a CPU tensor
  takes its plain version)
* ``plain`` -- the plain PyTorch walk, on any device
"""

from __future__ import annotations

import torch

from ..knn.ref import direct_d2
from . import tuning
from .kernel import knn_frontier, knn_frontier_plain
from .prep import BIG, prepare

FRONTIER_IMPLS = ("cuda", "plain")


def canonical_impl(impl: str) -> str:
    if impl not in FRONTIER_IMPLS:
        raise ValueError(f"unknown frontier impl {impl!r}; expected one of "
                         f"{FRONTIER_IMPLS}")
    return impl


def knn_frontier_impl(pts, valid, active, bbox_lo, bbox_hi, queries, *,
                      k: int, impl: str = "cuda", block_q=None,
                      block_p=None):
    """Frontier kNN over leaf-view arrays -> (d2, ids), ids flat
    ``row * C + col`` (-1 past the end). As in the reference, the walk's
    hits are un-sorted, rescored with the direct ``(q - p)^2`` on the
    original queries and ordered by ``(d2, id)``."""
    impl = canonical_impl(impl)
    bq, bp = tuning.tiles(impl, block_q, block_p)
    pr = prepare(pts, valid, active, bbox_lo, bbox_hi, queries,
                 block_q=bq, block_p=bp)
    walk = knn_frontier_plain if impl == "plain" else knn_frontier
    d2, ids, _ = walk(pr, pts, valid, active, k=k)
    q, D = queries.shape
    d2, ids = d2[:q][pr.inv], ids[:q][pr.inv]
    hit = pts.reshape(-1, D)[ids.clamp(min=0).long()].float()
    d2 = torch.where(ids < 0, BIG, direct_d2(queries.float()[:, None], hit))
    return sort_by_d2_id(d2, ids)


def sort_by_d2_id(d2, ids):
    """Order each row by ``(d2, id)`` (a stable sort by id, then by d2)
    and re-pad empty slots with -1."""
    o = torch.argsort(ids, dim=-1, stable=True)
    d2, ids = d2.gather(-1, o), ids.gather(-1, o)
    o = torch.argsort(d2, dim=-1, stable=True)
    d2, ids = d2.gather(-1, o), ids.gather(-1, o)
    return d2, torch.where(d2 >= BIG, -1, ids)
