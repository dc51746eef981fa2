"""Arithmetic shared by the kNN kernels' plain PyTorch versions.

Counterpart of ``repro/kernels/knn/ref.py`` (the f32 brute-force
oracle). Both CUDA kernels compute the *direct* squared distance
``sum_d (q_d - p_d)^2`` in f32, summed in order ``d = 0..D-1`` with no
fused multiply-add; the helpers here spell exactly that, so a plain
version equals its kernel bit for bit on any data.
:func:`knn_flat_split_plain` spells the flat kernel's split and merge
(``csrc/knn_flat.cu``) so the CPU tests can show it changes no bit.
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


SPLIT_ALIGN = 32   # a split's slot count is a multiple of this


def split_size(n: int, splits: int) -> int:
    """Slots of each split (the last may hold fewer) when ``n`` slots
    are cut into at most ``splits`` ranges."""
    per = -(-max(n, 1) // max(splits, 1))
    return -(-per // SPLIT_ALIGN) * SPLIT_ALIGN


def knn_flat_split_plain(queries, points, ok, *, k: int, splits: int):
    """The flat kernel's arithmetic: the slots cut into ranges of
    :func:`split_size`, each range's top-k by ``(d2, slot)`` (invalid
    slots never enter; an empty entry is ``BIG``), then the ranges' lists
    merged in range order keeping the ``k`` smallest by ``(d2, slot)``.
    Returns ``(d2 (Q, k) ascending, idx (Q, k) int32, -1-padded)``."""
    q = queries.float()
    p = points.float()
    Q, n = q.shape[0], p.shape[0]
    per = split_size(n, splits)
    lists_d, lists_i = [], []
    for s0 in range(0, max(n, 1), per):
        s1 = min(s0 + per, n)
        d2 = direct_d2(q[:, None, :], p[None, s0:s1, :])
        d2 = torch.where(ok[None, s0:s1], d2, BIG)
        pad = torch.full((Q, k), BIG, device=q.device)
        d2 = torch.cat([d2, pad], dim=1)              # every list k long
        order = torch.argsort(d2, dim=1, stable=True)[:, :k]
        lists_d.append(d2.gather(1, order))
        lists_i.append(order + s0)
    all_d = torch.cat(lists_d, dim=1)
    order = torch.argsort(all_d, dim=1, stable=True)[:, :k]
    d2k = all_d.gather(1, order)
    ids = torch.cat(lists_i, dim=1).gather(1, order)
    return d2k, torch.where(d2k >= BIG, -1, ids.int())
