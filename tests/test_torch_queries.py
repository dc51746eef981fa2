"""Port parity: ``repro_torch.core.queries`` against ``repro.core.queries``
on trees built by JAX and carried over with ``SpacTree.from_numpy``.

kNN answers must be bit-equal on the tie-free window (integer
coordinates < 2^10, no distance tie at any k boundary) and on the
offset-2^23 data (coordinates far outside the absolute f32-exact window,
spread < 2^9, so every (q - p) and its square stay exact). Range answers
are integer counts and ids and must be bit-equal on any data.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import queries as jq
from repro.core import spac as jspac
from repro_torch.core import queries, spac

torch.set_num_threads(1)

PHI, K = 8, 5


def _tie_free(offset: int, spread: int, n: int, q: int, k: int):
    for seed in range(64):
        rng = np.random.default_rng(seed + offset % 997)
        pts = (offset + rng.integers(0, spread, size=(n, 2))).astype(np.int32)
        qs = (offset + rng.integers(0, spread, size=(q, 2))).astype(np.int32)
        d2 = np.sort(((pts[None].astype(np.int64)
                       - qs[:, None].astype(np.int64)) ** 2).sum(-1), 1)
        if (d2[:, k - 1] != d2[:, k]).all():
            return pts, qs
    raise AssertionError("no tie-free seed found")


DATA = {"window": _tie_free(0, 1 << 10, 700, 16, K),
        "offset23": _tie_free(1 << 23, 1 << 9, 300, 8, K)}


def _views(pts):
    ref = jspac.build(jnp.asarray(pts), phi=PHI, coord_bits=30)
    fields = {f: np.asarray(getattr(ref, f)) for f in spac.FIELDS}
    tree = spac.SpacTree.from_numpy(fields, dict(
        phi=ref.phi, curve=ref.curve, bits=ref.bits,
        coord_bits=ref.coord_bits), "cpu")
    return ref.view(), tree.view()


def oracle_knn_d2(pts, qs, k):
    d2 = ((pts[None].astype(np.int64)
           - qs[:, None].astype(np.int64)) ** 2).sum(-1)
    return np.sort(d2, axis=1)[:, :k]


@pytest.mark.parametrize("data", sorted(DATA))
@pytest.mark.parametrize("chunk", [4, 16])
def test_knn_bit_equal(data, chunk):
    pts, qs = DATA[data]
    jview, view = _views(pts)
    d2_w, ids_w = jq.knn(jview, jnp.asarray(qs), K, chunk)
    d2, ids = queries.knn_impl(view, torch.as_tensor(qs), K, chunk)
    np.testing.assert_array_equal(d2.numpy(), np.asarray(d2_w))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_w))
    np.testing.assert_array_equal(d2.numpy().astype(np.int64),
                                  oracle_knn_d2(pts, qs, K))
    got = queries.gather_points(view, ids).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jq.gather_points(jview, ids_w)))


def test_knn_chunks_of_queries_change_nothing(monkeypatch):
    """The port walks queries in chunks of PAIR_BUDGET (query, row)
    pairs; a budget of one query per chunk gives the same answers."""
    pts, qs = DATA["window"]
    _, view = _views(pts)
    want = queries.knn_impl(view, torch.as_tensor(qs), K)
    monkeypatch.setattr(queries, "PAIR_BUDGET", 1)
    got = queries.knn_impl(view, torch.as_tensor(qs), K)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_knn_more_neighbours_than_points():
    pts, qs = DATA["window"]
    jview, view = _views(pts[:3])
    d2_w, ids_w = jq.knn(jview, jnp.asarray(qs), 8, 8)
    d2, ids = queries.knn_impl(view, torch.as_tensor(qs), 8, 8)
    np.testing.assert_array_equal(d2.numpy(), np.asarray(d2_w))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_w))
    assert (ids.numpy()[:, 3:] == -1).all()


def _boxes(seed, q, lo_hi, ext):
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, lo_hi, size=(q, 2)).astype(np.int32)
    return lo, lo + rng.integers(1, ext, size=(q, 2)).astype(np.int32)


@pytest.mark.parametrize("max_rows", [4, 32, 128, 1000])
def test_range_rows_and_counts(max_rows):
    rng = np.random.default_rng(3)
    pts = rng.integers(0, 1 << 20, size=(2500, 2)).astype(np.int32)
    jview, view = _views(pts)
    lo, hi = _boxes(4, 12, 1 << 19, 1 << 18)
    R = view.pts.shape[0]
    rows, rows_ok, trunc = queries._range_rows(
        view, torch.as_tensor(lo), torch.as_tensor(hi), max_rows)
    for i in range(lo.shape[0]):
        w = jq._range_rows(jview, jnp.asarray(lo[i]), jnp.asarray(hi[i]),
                           max_rows)
        np.testing.assert_array_equal(rows[i].numpy(), np.asarray(w[0]))
        np.testing.assert_array_equal(rows_ok[i].numpy(), np.asarray(w[1]))
        assert bool(trunc[i]) == bool(w[2])
    assert rows.shape == (lo.shape[0], min(max_rows, R))
    cnt, tr = queries.range_count_impl(view, torch.as_tensor(lo),
                                       torch.as_tensor(hi), max_rows)
    cnt_w, tr_w = jq.range_count(jview, jnp.asarray(lo), jnp.asarray(hi),
                                 max_rows)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_w))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(tr_w))


@pytest.mark.parametrize("data", sorted(DATA))
def test_range_list_bit_equal(data):
    pts, _ = DATA[data]
    jview, view = _views(pts)
    base = int(pts.min())
    lo, hi = _boxes(5, 8, 300, 300)
    lo, hi = lo + base, hi + base
    ids, cnt, tr = queries.range_list_impl(
        view, torch.as_tensor(lo), torch.as_tensor(hi), 64, 128)
    ids_w, cnt_w, tr_w = jq.range_list_impl(
        jview, jnp.asarray(lo), jnp.asarray(hi), 64, 128)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_w))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_w))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(tr_w))
    assert cnt.sum() > 0


def test_flatten_view():
    pts, _ = DATA["window"]
    jview, view = _views(pts)
    for g, w in zip(queries.flatten_view(view), jq.flatten_view(jview)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
