"""Batched exact queries over leaf-row indexes.

Counterpart of ``repro/core/queries.py``. The reference vmaps a
per-query body over the batch; the port writes the batch dimension out.
kNN is the *chunked frontier traversal*: rows are visited in ascending
bbox-distance order with a running top-k, and a query stops as soon as
the next chunk's bound exceeds its k-th best. Range queries gather the
first ``max_rows`` rows (in row order) whose bbox overlaps the box, with
a truncation flag the engine escalates on.

Every per-query intermediate is ``(Q, R)``, so queries run in chunks of
at most :data:`PAIR_BUDGET` (query, row) pairs; chunking changes no
answer.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .leafstore import BIG

PAIR_BUDGET = 1 << 26


class LeafView(NamedTuple):
    pts: torch.Tensor      # (R, C, D) float32 or int32
    valid: torch.Tensor    # (R, C) bool
    active: torch.Tensor   # (R,) bool
    bbox_lo: torch.Tensor  # (R, D)
    bbox_hi: torch.Tensor  # (R, D)


def _chunks(q: int, rows: int):
    step = max(1, PAIR_BUDGET // max(rows, 1))
    return [(s, min(s + step, q)) for s in range(0, q, step)]


def _sum_sq(x):
    """Sum of squares over the last axis, in order d = 0..D-1."""
    acc = x[..., 0] * x[..., 0]
    for d in range(1, x.shape[-1]):
        acc = acc + x[..., d] * x[..., d]
    return acc


def dist2_point_box(q, lo, hi):
    """Squared distance from points q (Q, D) to boxes (R, D) -> (Q, R)."""
    qf = q.float()[:, None, :]
    d = torch.clamp_min(torch.maximum(lo.float()[None] - qf,
                                      qf - hi.float()[None]), 0.0)
    return _sum_sq(d)


def _knn_block(view: LeafView, q, k: int, chunk: int):
    R, C, dim = view.pts.shape
    Q = q.shape[0]
    dev = q.device
    n_chunks = (R + chunk - 1) // chunk
    dmin2 = torch.where(view.active[None, :],
                        dist2_point_box(q, view.bbox_lo, view.bbox_hi), BIG)
    row_order = torch.argsort(dmin2, dim=1, stable=True)
    dmin2_sorted = dmin2.gather(1, row_order)
    pad = n_chunks * chunk - R
    if pad:
        row_order = torch.cat([row_order, row_order.new_zeros((Q, pad))], 1)
        dmin2_sorted = torch.cat(
            [dmin2_sorted, torch.full((Q, pad), BIG, device=dev)], 1)
    best_d2 = torch.full((Q, k), BIG, device=dev)
    best_id = torch.full((Q, k), -1, dtype=torch.int32, device=dev)
    walking = torch.ones(Q, dtype=torch.bool, device=dev)
    qf = q.float()[:, None, None, :]
    lane = torch.arange(chunk, device=dev)
    slots = torch.arange(C, device=dev)
    for i in range(n_chunks):
        walking = walking & (dmin2_sorted[:, i * chunk] <= best_d2[:, k - 1])
        if not bool(walking.any()):
            break
        rows = row_order[:, i * chunk: (i + 1) * chunk]       # (Q, chunk)
        # tail padding aliases row 0: mask it so its points count once
        ok = (view.valid[rows] & view.active[rows][..., None]
              & (i * chunk + lane < R)[None, :, None])
        d2 = _sum_sq(view.pts[rows].float() - qf)              # (Q, chunk, C)
        d2 = torch.where(ok, d2, BIG).reshape(Q, -1)
        ids = (rows[..., None] * C + slots).reshape(Q, -1).int()
        cat_d2 = torch.cat([best_d2, d2], dim=1)
        cat_id = torch.cat([best_id, ids], dim=1)
        sel = torch.argsort(cat_d2, dim=1, stable=True)[:, :k]
        best_d2 = torch.where(walking[:, None], cat_d2.gather(1, sel),
                              best_d2)
        best_id = torch.where(walking[:, None], cat_id.gather(1, sel),
                              best_id)
    return best_d2, torch.where(best_d2 >= BIG, -1, best_id)


def knn_impl(view: LeafView, queries, k: int, chunk: int = 8):
    """Exact batched kNN by chunked frontier traversal -> (d2 (Q, k)
    ascending, flat ids (Q, k) = row*C+slot, -1 padded)."""
    outs = [_knn_block(view, queries[a:b], k, chunk)
            for a, b in _chunks(queries.shape[0], view.pts.shape[0])]
    return (torch.cat([o[0] for o in outs]),
            torch.cat([o[1] for o in outs]))


def gather_points(view: LeafView, flat_ids):
    """Resolve flat ids (row*C+slot) into coordinates (0 where id < 0)."""
    R, C, dim = view.pts.shape
    pts = view.pts.reshape(R * C, dim)[flat_ids.clamp(min=0).long()]
    return torch.where((flat_ids >= 0)[..., None], pts, 0)


def flatten_view(view: LeafView):
    """Flat (R*C, D) points + validity; flat index == row*C+slot."""
    R, C, dim = view.pts.shape
    ok = (view.valid & view.active[:, None]).reshape(R * C)
    return view.pts.reshape(R * C, dim), ok


def _range_rows(view: LeafView, lo, hi, max_rows: int):
    """The first ``min(max_rows, R)`` rows overlapping each box, in row
    order (the reference's ``lax.top_k`` pick), padded with the lowest
    non-overlapping rows; plus per-row overlap and truncation flags.

    Keys are unique (overlapping row ``r`` -> ``r``, other rows ->
    ``R + r``), so ``torch.topk`` has no ties to break and picks the
    reference's rows in the reference's order."""
    R = view.pts.shape[0]
    lf, hf = lo.float()[:, None, :], hi.float()[:, None, :]
    overlap = ((view.bbox_lo.float()[None] <= hf)
               & (lf <= view.bbox_hi.float()[None])).all(dim=-1) \
        & view.active[None]
    n_overlap = overlap.sum(dim=1, dtype=torch.int32)
    r = torch.arange(R, dtype=torch.int32, device=lo.device)
    key = torch.where(overlap, r, R + r)
    rows = torch.topk(key, min(int(max_rows), R), dim=1, largest=False,
                      sorted=True).indices
    return rows, overlap.gather(1, rows), n_overlap > max_rows


def _range_inside(view: LeafView, lo, hi, max_rows: int):
    rows, rows_ok, truncated = _range_rows(view, lo, hi, max_rows)
    pts = view.pts[rows].float()                       # (Q, M, C, D)
    lf, hf = lo.float()[:, None, None, :], hi.float()[:, None, None, :]
    inside = (((pts >= lf) & (pts <= hf)).all(dim=-1)
              & view.valid[rows] & rows_ok[..., None])
    return rows, inside, truncated


def _range_count_block(view, lo, hi, max_rows):
    _, inside, truncated = _range_inside(view, lo, hi, max_rows)
    return inside.sum(dim=(1, 2), dtype=torch.int32), truncated


def range_count_impl(view: LeafView, lo, hi, max_rows: int = 128):
    """Exact batched range count over inclusive boxes lo/hi (Q, D) ->
    (counts (Q,), truncated (Q,)); truncated means max_rows was too
    small (the engine resizes and re-runs)."""
    outs = [_range_count_block(view, lo[a:b], hi[a:b], max_rows)
            for a, b in _chunks(lo.shape[0], view.pts.shape[0])]
    return (torch.cat([o[0] for o in outs]),
            torch.cat([o[1] for o in outs]))


def _range_list_block(view, lo, hi, max_rows, cap):
    C = view.pts.shape[1]
    rows, inside, truncated = _range_inside(view, lo, hi, max_rows)
    Q = lo.shape[0]
    flat_in = inside.reshape(Q, -1)
    m = flat_in.shape[1]
    flat_ids = (rows[..., None] * C
                + torch.arange(C, device=lo.device)).reshape(Q, -1).int()
    # stable compaction of hits to the front
    key = torch.where(flat_in, torch.arange(m, dtype=torch.int32,
                                            device=lo.device), m)
    sel = torch.argsort(key, dim=1, stable=True)[:, :cap]
    ids = torch.where(flat_in.gather(1, sel), flat_ids.gather(1, sel), -1)
    return ids, flat_in.sum(dim=1, dtype=torch.int32), truncated


def range_list_impl(view: LeafView, lo, hi, max_rows: int = 128,
                    cap: int = 512):
    """Exact batched range report -> (ids (Q, <= cap) flat row*C+slot
    padded with -1, counts (Q,), rows_trunc (Q,)). ``counts`` is exact
    whenever rows_trunc is False, even past ``cap``."""
    outs = [_range_list_block(view, lo[a:b], hi[a:b], max_rows, cap)
            for a, b in _chunks(lo.shape[0], view.pts.shape[0])]
    return tuple(torch.cat([o[i] for o in outs]) for i in range(3))
