"""Arithmetic shared by the kNN kernels' plain PyTorch versions.

Counterpart of ``repro/kernels/knn/ref.py`` (the f32 brute-force
oracle). Both CUDA kernels compute the *direct* squared distance
``sum_d (q_d - p_d)^2`` in f32, summed in order ``d = 0..D-1`` with no
fused multiply-add; the helpers here spell exactly that, so a plain
version equals its kernel bit for bit on any data.
"""

from __future__ import annotations

import torch

BIG = 3.4e38  # python float: rounds to the same f32 as the kernels' 3.4e38f


def direct_d2(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Squared distance between f32 ``q (..., D)`` and ``p (..., D)``
    (broadcast over the leading dims), summed in order over ``D``."""
    df = q[..., 0] - p[..., 0]
    acc = df * df
    for d in range(1, q.shape[-1]):
        df = q[..., d] - p[..., d]
        acc = acc + df * df
    return acc


def merge_topk(dist, idx, d2, ids, k: int):
    """The ``k`` smallest of ``[running, tile]`` along the last axis, in
    ``lax.top_k``'s order: ascending distance, ties by position (so a
    running entry precedes an equal tile entry, and tile entries keep id
    order)."""
    all_d = torch.cat([dist, d2], dim=-1)
    all_i = torch.cat([idx, ids.expand(all_d.shape[:-1] + ids.shape[-1:])],
                      dim=-1)
    order = torch.argsort(all_d, dim=-1, stable=True)[..., :k]
    return all_d.gather(-1, order), all_i.gather(-1, order)
