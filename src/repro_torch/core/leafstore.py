"""Shared leaf-row machinery for array-based spatial indexes.

Counterpart of ``repro/core/leafstore.py``: a leaf is a row of an
``(R, C)`` array (``C = 2 * phi`` slots) plus a validity mask; batch
appends are masked scatters into slack slots, deletions are ranked
multiset matches plus an intra-row stable compaction. Every helper is
fixed-shape -- no boolean-mask indexing, ``nonzero`` or host reads -- so
the update path enqueues device work without a sync.

JAX's ``mode="drop"`` scatters become scatters into one extra trailing
row that is sliced off (:func:`_scatter_drop`).
"""

from __future__ import annotations

import torch

from ..kernels.bbox import kernel as bbox_kernel
from ..kernels.bbox.ref import dtype_max as _big_for

BIG = 3.4e38  # f32 +inf stand-in that survives arithmetic


def _scatter_drop(target, row, col, values, mask):
    """``target[row[i], col[i]] = values[i]`` where ``mask[i]`` and the
    slot is in range; other entries land in a trailing dummy slot that is
    dropped (JAX's ``mode="drop"``). Returns a new tensor."""
    R, C = target.shape[:2]
    flat = torch.cat([target.reshape((R * C,) + target.shape[2:]),
                      target.new_zeros((1,) + target.shape[2:])])
    keep = mask & (row >= 0) & (row < R) & (col >= 0) & (col < C)
    idx = torch.where(keep, row.long() * C + col.long(), R * C)
    flat.index_put_((idx,), values.to(target.dtype))
    return flat[: R * C].reshape(target.shape)


def _add_drop(n: int, idx, mask, dtype=torch.int32):
    """Histogram: ``out[idx[i]] += 1`` where ``mask[i]`` and
    ``0 <= idx[i] < n``."""
    out = torch.zeros(n + 1, dtype=dtype, device=idx.device)
    keep = mask & (idx >= 0) & (idx < n)
    out.index_add_(0, torch.where(keep, idx.long(), n),
                   torch.ones_like(idx, dtype=dtype))
    return out[:n]


def _reduce_drop(base, idx, values, mask, how: str):
    """``out = base.at[idx].min/max(values)`` over masked, in-range
    entries (``how`` is ``"amin"`` or ``"amax"``)."""
    n = base.shape[0]
    out = torch.cat([base, base[:1]])
    tgt = torch.where(mask & (idx >= 0) & (idx < n), idx.long(), n)
    if values.dim() > 1:
        tgt = tgt[:, None].expand(values.shape)
    return out.scatter_reduce_(0, tgt, values.to(base.dtype), how,
                               include_self=True)[:n]


def _set_rows_drop(target, idx, values):
    """``target.at[idx].set(values, mode="drop")`` along dim 0: entries
    with ``idx`` outside ``[0, R)`` land in a dropped trailing row."""
    n = target.shape[0]
    out = torch.cat([target, target.new_zeros((1,) + target.shape[1:])])
    out[torch.where((idx >= 0) & (idx < n), idx.long(), n)] = \
        values.to(target.dtype)
    return out[:n]


def chunk_rows_from_sorted(n_total: int, phi: int, device=None):
    """(row, slot) for positions 0..n_total-1 packed into rows of phi."""
    pos = torch.arange(n_total, dtype=torch.int32, device=device)
    return pos // phi, pos % phi


def scatter_to_rows(target, row, slot, values, mask):
    """Masked scatter of ``values[i]`` into ``target[row[i], slot[i]]``."""
    return _scatter_drop(target, row, slot, values, mask)


def segment_bbox(points, row, mask, num_rows: int):
    """Tight per-row bounding boxes: ``(lo, hi)`` of shape
    ``(num_rows, D)``; rows with no points get (+big, -big)."""
    dim, dt = points.shape[-1], points.dtype
    big = _big_for(dt)
    lo = torch.full((num_rows, dim), big, dtype=dt, device=points.device)
    hi = torch.full((num_rows, dim), -big, dtype=dt, device=points.device)
    return (_reduce_drop(lo, row, points, mask, "amin"),
            _reduce_drop(hi, row, points, mask, "amax"))


def row_bbox_from_slots(pts, valid):
    """(lo, hi) over the valid slots of each row, in the points' dtype.
    pts: (R, C, D). CUDA tensors go to the row-bbox kernel
    (``kernels/bbox``), CPU tensors to its plain version."""
    return bbox_kernel.row_bbox(pts, valid)


def run_first(change):
    """Index of the first element of each element's run, where ``change``
    marks the run starts (``change[0]`` set) -- ``cummax(where(change,
    idx, 0))`` -- by one scatter and one gather: a run start writes its
    index at its run id, every other element into a slot of its own past
    ``n``. (torch's cummax runs a scan-with-indices kernel that is slow
    on CUDA.) int32."""
    n = change.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=change.device)
    run = torch.cumsum(change, 0) - 1
    first = torch.empty(2 * n, dtype=torch.int32, device=change.device)
    first.scatter_(0, torch.where(change, run, n + idx.long()), idx)
    return first[run]


def group_occurrence(group_ids):
    """Occurrence index of each element within its (contiguous) run."""
    n = group_ids.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=group_ids.device)
    change = torch.ones(n, dtype=torch.bool, device=group_ids.device)
    change[1:] = group_ids[1:] != group_ids[:-1]
    return idx - run_first(change)


def append_unsorted(pts_rows, valid_rows, count, row_of, new_pts, new_mask,
                    extras_rows=(), new_extras=()):
    """The partial-order relaxation: scatter-append a batch sorted by row
    into row slack slots without sorting row contents. Returns updated
    (pts_rows, valid_rows, count, extras)."""
    C = pts_rows.shape[1]
    R = count.shape[0]
    occ = group_occurrence(row_of)
    slot = count[row_of.clamp(max=R - 1).long()] + occ
    ok = new_mask & (slot < C)
    pts_rows = scatter_to_rows(pts_rows, row_of, slot, new_pts, ok)
    valid_rows = scatter_to_rows(
        valid_rows, row_of, slot,
        torch.ones(new_pts.shape[0], dtype=torch.bool,
                   device=new_pts.device), ok)
    adds = _add_drop(R, row_of, ok)
    out_extras = tuple(scatter_to_rows(tgt, row_of, slot, val, ok)
                       for tgt, val in zip(extras_rows, new_extras))
    return pts_rows, valid_rows, count + adds, out_extras


def batch_rank_among_equals(sorted_pts, row_of, window: int, mask=None):
    """Rank of each batch entry among the masked-in entries with equal
    (row, coords) among its ``window`` predecessors."""
    n = sorted_pts.shape[0]
    dev = sorted_pts.device
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=dev)
    prev = (torch.arange(n, device=dev)[:, None]
            - torch.arange(1, window + 1, device=dev)[None, :])
    has = prev >= 0
    prev = prev.clamp(min=0)
    same = (has & mask[prev] & (row_of[prev] == row_of[:, None])
            & (sorted_pts[prev] == sorted_pts[:, None, :]).all(dim=-1))
    return same.sum(dim=1, dtype=torch.int32)


def slot_rank_among_equals(pts_rows, valid_rows):
    """For every slot: the number of earlier valid slots in its row that
    hold an identical point. pts_rows: (R, C, D) -> (R, C) int32 (an
    ``(R, C, C)`` compare; :func:`ranked_delete` gets the same rank for
    the slots it needs from one row per entry)."""
    eq = (pts_rows[:, :, None, :] == pts_rows[:, None, :, :]).all(dim=-1)
    C = pts_rows.shape[1]
    earlier = torch.ones((C, C), dtype=torch.bool,
                         device=pts_rows.device).tril(-1)
    return (eq & earlier & valid_rows[:, None, :]).sum(dim=-1,
                                                       dtype=torch.int32)


def ranked_delete(pts_rows, valid_rows, count, row_of, del_pts, del_mask,
                  window: int):
    """Delete a batch sorted by row with exact multiset semantics: each
    entry removes at most one matching valid slot, and equal entries
    remove distinct copies (entry of rank r takes the r-th matching slot).

    The reference ranks every slot of the tree against its row
    (:func:`slot_rank_among_equals`, an ``(R, C, C)`` compare); a slot
    that matches the entry has that rank equal to the number of earlier
    matching valid slots, so the port takes an exclusive cumsum over the
    entry's own row instead -- the same rank, without the tree-wide
    compare. Returns (valid_rows, count, matched)."""
    R, C, _ = pts_rows.shape
    n = del_pts.shape[0]
    brank = batch_rank_among_equals(del_pts, row_of, window, del_mask)
    r = row_of.long()
    cand = ((pts_rows[r] == del_pts[:, None, :]).all(dim=-1)
            & valid_rows[r])                                   # (n, C)
    srank = torch.cumsum(cand, dim=1, dtype=torch.int32) - cand.int()
    hit = cand & (srank == brank[:, None]) & del_mask[:, None]
    matched = hit.any(dim=-1)
    slot = hit.int().argmax(dim=-1)
    valid_rows = scatter_to_rows(
        valid_rows, row_of, slot,
        torch.zeros(n, dtype=torch.bool, device=del_pts.device), matched)
    return valid_rows, count - _add_drop(R, row_of, matched), matched


def compact_rows(valid_rows, *slot_arrays):
    """Stable push-valid-to-front within each row, applying the same
    permutation to every (R, C, ...) array in ``slot_arrays``."""
    order = torch.argsort((~valid_rows).to(torch.uint8), dim=1, stable=True)
    out = [valid_rows.gather(1, order)]
    for arr in slot_arrays:
        idx = order.reshape(order.shape + (1,) * (arr.dim() - 2))
        out.append(arr.gather(1, idx.expand(order.shape + arr.shape[2:])))
    return tuple(out)


def take_k_where(mask, k: int):
    """Indices of up to k True entries of mask (ascending, padded with
    -1) and the count of True entries."""
    n = mask.shape[0]
    key = torch.where(mask, torch.arange(n, dtype=torch.int32,
                                         device=mask.device), n)
    idx = torch.argsort(key, stable=True)[:k]
    good = mask[idx]
    return (torch.where(good, idx.int(), -1),
            mask.sum(dtype=torch.int32))
