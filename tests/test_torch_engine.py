"""Port parity: ``repro_torch.core.engine`` against ``repro.core.engine``,
mirroring tests/test_queries_parity.py: every kNN route returns the
reference facade's answers bit for bit on tie-free data, range buffers
escalate within the O(log R) plan bound and are remembered, and
``canonical_knn`` orders ties as the reference's two-key sort does."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import make_index as j_make_index
from repro_torch.core import engine, make_index

torch.set_num_threads(1)

PHI = 8
N, Q, K = 700, 16, 5
COORD_HI = 1 << 10
KINDS = ("spac-h", "spac-z", "cpam-h", "porth", "kd", "zd")


def _tie_free_data(n: int, q: int, k: int):
    for seed in range(64):
        rng = np.random.default_rng(seed)
        pts = rng.integers(0, COORD_HI, size=(n, 2)).astype(np.int32)
        qs = rng.integers(0, COORD_HI, size=(q, 2)).astype(np.int32)
        d2 = np.sort(((pts[None].astype(np.int64)
                       - qs[:, None].astype(np.int64)) ** 2).sum(-1), 1)
        if (d2[:, k - 1] != d2[:, k]).all():
            return pts, qs
    raise AssertionError("no tie-free seed found")


PTS, QS = _tie_free_data(N, Q, K)


def oracle_knn_d2(pts, qs, k):
    d2 = ((pts[None].astype(np.int64)
           - qs[:, None].astype(np.int64)) ** 2).sum(-1)
    return np.sort(d2, axis=1)[:, :k]


@pytest.mark.parametrize("kind", KINDS)
def test_every_route_matches_the_reference_facade(kind):
    ref = j_make_index(kind, jnp.asarray(PTS), phi=PHI)
    d2_w, ids_w = map(np.asarray, ref.knn(jnp.asarray(QS), K,
                                          impl="frontier"))
    np.testing.assert_array_equal(d2_w.astype(np.int64),
                                  oracle_knn_d2(PTS, QS, K))
    idx = make_index(kind, PTS, phi=PHI, device="cpu")
    for impl in engine.KNN_IMPLS:
        d2, ids = idx.knn(QS, K, impl=impl)
        np.testing.assert_array_equal(d2.numpy(), d2_w, err_msg=impl)
        np.testing.assert_array_equal(ids.numpy(), ids_w, err_msg=impl)


def test_planner_routes():
    eng = engine.QueryEngine()
    assert eng.plan_knn(512, 64) == ("flat", "cuda")        # 2^15 slots
    assert eng.plan_knn(513, 64) == ("frontier-kernel", "cuda")
    assert eng.plan_knn(513, 64, "plain-frontier") == \
        ("frontier-kernel", "plain")
    assert eng.plan_knn(4096, 64, "frontier") == \
        ("frontier", engine.auto_chunk(4096))
    with pytest.raises(ValueError, match="unknown kNN impl"):
        eng.plan_knn(8, 8, "pallas")


def test_route_counts_and_plan_cache():
    idx = make_index("spac-h", PTS, phi=PHI, device="cpu")
    engine._knn_plan.cache_clear()
    engine.reset_trace_count()
    for _ in range(3):
        idx.knn(QS, K)
    assert engine.trace_count() == 1
    idx.knn(QS, K, impl="frontier")           # another plan
    assert engine.trace_count() == 2
    chunk = engine.auto_chunk(idx.view().pts.shape[0])
    assert idx.engine.route_counts == {"flat:cuda": 3,
                                       f"frontier:{chunk}": 1}


def test_canonical_knn_matches_reference_two_key_sort():
    rng = np.random.default_rng(1)
    d2 = rng.integers(0, 4, size=(50, 12)).astype(np.float32)
    d2[rng.random(d2.shape) < 0.2] = 3.4e38
    ids = rng.permutation(50 * 12).reshape(50, 12).astype(np.int32)
    got = engine.canonical_knn(torch.as_tensor(d2), torch.as_tensor(ids))
    want = jengine.canonical_knn(jnp.asarray(d2), jnp.asarray(ids))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_range_escalation_trace_bound():
    """From a tiny starting bucket the engine reaches the exact answer in
    <= log2(R) + 1 plans; an identical follow-up builds none."""
    rng = np.random.default_rng(2)
    n = 2000
    pts = rng.integers(0, 1 << 20, size=(n, 2)).astype(np.int32)
    idx = make_index("spac-h", pts, phi=PHI, device="cpu")
    idx.engine.start_rows = 8
    rows = idx.capacity_rows
    lo = np.zeros((4, 2), np.int32)
    hi = np.full((4, 2), (1 << 20) - 1, np.int32)

    engine._range_count_plan.cache_clear()
    engine.reset_trace_count()
    cnt = idx.range_count(lo, hi)
    assert (cnt.numpy() == n).all()
    traces = engine.trace_count()
    bound = int(np.ceil(np.log2(rows))) + 1
    assert 2 <= traces <= bound, (traces, bound)
    np.testing.assert_array_equal(idx.range_count(lo, hi).numpy(),
                                  cnt.numpy())
    assert engine.trace_count() == traces
    # the engine rides along across updates: the bucket is remembered
    idx2 = idx.insert(rng.integers(0, 1 << 20, size=(64, 2)).astype(
        np.int32))
    assert (idx2.range_count(lo, hi).numpy() == n + 64).all()
    assert engine.trace_count() == traces


def test_range_list_escalates_rows_and_cap():
    rng = np.random.default_rng(3)
    n = 1500
    pts = rng.integers(0, 1 << 20, size=(n, 2)).astype(np.int32)
    idx = make_index("spac-h", pts, phi=5, device="cpu")
    lo = np.zeros((2, 2), np.int32)
    hi = np.full((2, 2), (1 << 20) - 1, np.int32)
    ids, cnt = idx.range_list(lo, hi)
    assert (cnt.numpy() == n).all()
    assert int((ids >= 0).sum()) == 2 * n
    _, cap = idx.engine._buckets[("range_list", 2, 2, "torch.int32")]
    assert ids.shape[1] == cap
