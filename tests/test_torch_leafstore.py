"""Port parity: ``repro_torch.core.leafstore`` against
``repro.core.leafstore``. Every helper gets the same numpy inputs on both
sides and must return bit-equal arrays (the reference's ``mode="drop"``
scatters and ``.at[].min/max`` included)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import leafstore as jls
from repro_torch.core import leafstore as ls

torch.set_num_threads(1)

R, C, D = 24, 8, 2


def _eq(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _t(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _rows(rng, dup=False):
    hi = 4 if dup else 1 << 20
    pts = rng.integers(0, hi, size=(R, C, D)).astype(np.int32)
    valid = rng.random((R, C)) > 0.3
    return pts, valid


def test_chunk_rows_from_sorted():
    _eq(ls.chunk_rows_from_sorted(77, 8), jls.chunk_rows_from_sorted(77, 8))


@pytest.mark.parametrize("dtype", [np.int32, np.int64, bool])
def test_scatter_to_rows_drops_masked_and_out_of_range(dtype):
    rng = np.random.default_rng(1)
    n = 40
    target = rng.integers(0, 9, size=(R, C)).astype(dtype)
    flat = rng.choice(R * C, size=n, replace=False)
    row, slot = (flat // C).astype(np.int32), (flat % C).astype(np.int32)
    row[:5] = R                                    # out of range: dropped
    values = rng.integers(0, 9, size=n).astype(dtype)
    mask = rng.random(n) > 0.2
    args = (target, row, slot, values, mask)
    _eq(ls.scatter_to_rows(*_t(*args)), jls.scatter_to_rows(*_j(*args)))


def test_segment_bbox():
    rng = np.random.default_rng(2)
    pts = rng.integers(-1000, 1000, size=(90, D)).astype(np.int32)
    row = rng.integers(0, R + 2, size=90).astype(np.int32)
    mask = rng.random(90) > 0.3
    _eq(ls.segment_bbox(*_t(pts, row, mask), R),
        jls.segment_bbox(*_j(pts, row, mask), R))


def test_row_bbox_from_slots():
    pts, valid = _rows(np.random.default_rng(3))
    valid[0] = False                               # an empty row
    _eq(ls.row_bbox_from_slots(*_t(pts, valid)),
        jls.row_bbox_from_slots(*_j(pts, valid)))


def test_group_occurrence():
    ids = np.array([5, 5, 5, 2, 2, 9, 1, 1, 1, 1, 5], np.int32)
    _eq(ls.group_occurrence(torch.as_tensor(ids)),
        jls.group_occurrence(jnp.asarray(ids)))


@pytest.mark.parametrize("n", [0, 1, 2, 1000])
def test_run_first_matches_cummax(n):
    """The scatter formulation equals the reference's associative-scan
    maximum over ``where(change, idx, 0)``."""
    rng = np.random.default_rng(n)
    change = rng.random(n) < 0.1
    if n:
        change[0] = True
    idx = np.arange(n, dtype=np.int32)
    want = np.maximum.accumulate(np.where(change, idx, 0)) if n else idx
    got = ls.run_first(torch.as_tensor(change))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_append_unsorted():
    rng = np.random.default_rng(4)
    pts, valid = _rows(rng)
    count = rng.integers(0, C + 1, size=R).astype(np.int32)
    valid = np.arange(C)[None, :] < count[:, None]
    codes = rng.integers(0, 1 << 30, size=(R, C)).astype(np.int64)
    n = 60
    row_of = np.sort(rng.integers(0, R + 1, size=n)).astype(np.int32)
    new_pts = rng.integers(0, 1 << 20, size=(n, D)).astype(np.int32)
    new_codes = rng.integers(0, 1 << 30, size=n).astype(np.int64)
    mask = rng.random(n) > 0.2
    got = ls.append_unsorted(*_t(pts, valid, count, row_of, new_pts, mask),
                             extras_rows=_t(codes),
                             new_extras=_t(new_codes))
    want = jls.append_unsorted(
        *_j(pts, valid, count, row_of, new_pts, mask),
        extras_rows=(jnp.asarray(codes.astype(np.uint32)),),
        new_extras=(jnp.asarray(new_codes.astype(np.uint32)),))
    _eq(got[:3], want[:3])
    np.testing.assert_array_equal(got[3][0].numpy().astype(np.uint32),
                                  np.asarray(want[3][0]))


def _sorted_batch(rng, n):
    row_of = np.sort(rng.integers(0, R, size=n)).astype(np.int32)
    pts = rng.integers(0, 3, size=(n, D)).astype(np.int32)
    mask = rng.random(n) > 0.2
    return pts, row_of, mask


def test_batch_rank_among_equals():
    pts, row_of, mask = _sorted_batch(np.random.default_rng(5), 120)
    for m in (None, mask):
        _eq(ls.batch_rank_among_equals(*_t(pts, row_of), C,
                                       None if m is None else _t(m)[0]),
            jls.batch_rank_among_equals(*_j(pts, row_of), C,
                                        None if m is None else _j(m)[0]))


def test_slot_rank_among_equals():
    pts, valid = _rows(np.random.default_rng(6), dup=True)
    _eq(ls.slot_rank_among_equals(*_t(pts, valid)),
        jls.slot_rank_among_equals(*_j(pts, valid)))


def test_ranked_delete_multiset():
    """Duplicate points in rows and in the batch: each entry removes one
    distinct copy, exactly as the reference's (R, C, C) rank match."""
    rng = np.random.default_rng(7)
    pts, valid = _rows(rng, dup=True)
    count = valid.sum(1).astype(np.int32)
    dpts, row_of, mask = _sorted_batch(rng, 150)
    got = ls.ranked_delete(*_t(pts, valid, count, row_of, dpts, mask),
                           window=C)
    want = jls.ranked_delete(*_j(pts, valid, count, row_of, dpts, mask),
                             window=C)
    _eq(got, want)
    assert got[2].any() and not got[2].all()


def test_compact_rows():
    rng = np.random.default_rng(8)
    pts, valid = _rows(rng)
    codes = rng.integers(0, 1 << 30, size=(R, C)).astype(np.int64)
    _eq(ls.compact_rows(*_t(valid, pts, codes)),
        jls.compact_rows(*_j(valid, pts, codes)))


@pytest.mark.parametrize("k", [1, 5, 24, 40])
def test_take_k_where(k):
    mask = np.random.default_rng(9).random(R) > 0.6
    _eq(ls.take_k_where(torch.as_tensor(mask), k),
        jls.take_k_where(jnp.asarray(mask), k))
