"""Port parity: ``make_index("kd" | "zd")`` against
``repro.core.make_index``: facade traces (inserts sized from the
host-side bound, size-checked and doubled; deletes at the current rows),
the clustered rebuild-retry input of ``tests/test_index_api.py``
included, leave every ``LeafIndex`` field bit-equal to the reference
facade's; the engine's kNN (every route) and range answers are
bit-equal; and zd refuses codes wider than 32 bits.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import index as jindex
from repro_torch.core import baselines, engine, make_index

torch.set_num_threads(1)

PHI = 8
HI = 1 << 20


def assert_trees_equal(port_tree, ref_tree, where: str):
    got = port_tree.to_numpy()
    for f in baselines.FIELDS:
        want = np.asarray(getattr(ref_tree, f))
        assert got[f].dtype == want.dtype, (where, f)
        np.testing.assert_array_equal(got[f], want,
                                      err_msg=f"{where}: field {f}")


def _clustered():
    """tests/test_index_api.py:test_rebuild_insert_clustered_no_silent_drop:
    150 clusters of 33 points, far more rows than the slack heuristic."""
    rng = np.random.default_rng(0)
    centers = rng.integers(0, 1 << 20, size=(150, 2)).astype(np.int32)
    offs = (np.arange(33) * (1 << 5)).astype(np.int32)
    pts = (centers[:, None, :]
           + np.stack([offs, offs], -1)[None]).reshape(-1, 2)
    return np.clip(pts, 0, (1 << 20) - 1).astype(np.int32)


@pytest.mark.parametrize("kind,data", [("kd", "uniform"), ("zd", "uniform"),
                                       ("kd", "clustered"),
                                       ("zd", "clustered")])
def test_facade_trace_bit_equal(kind, data):
    """``make_index`` plus inserts (sized from the host-side bound, then
    size-checked and doubled) and deletes (at the current rows), each
    tree bit-equal to the reference facade's."""
    if data == "clustered":
        pts = _clustered()
        first, batches = pts[:64], [pts[64:]]
    else:
        rng = np.random.default_rng(31)
        first = rng.integers(0, HI, size=(500, 2)).astype(np.int32)
        batches = [rng.integers(0, HI, size=(200, 2)).astype(np.int32)
                   for _ in range(2)]
    kw = dict(max_depth=16) if kind == "kd" else {}
    ref = jindex.make_index(kind, jnp.asarray(first), phi=PHI, **kw)
    idx = make_index(kind, first, phi=PHI, device="cpu", **kw)
    assert_trees_equal(idx.tree, ref.tree, "build")
    total = first.shape[0]
    for s, batch in enumerate(batches):
        ref = ref.insert(jnp.asarray(batch))
        idx = idx.insert(batch)
        total += batch.shape[0]
        assert_trees_equal(idx.tree, ref.tree, f"step {s} insert")
        assert idx.capacity_rows == ref.capacity_rows
        gone = first[s * 40: (s + 1) * 40]
        ref = ref.delete(jnp.asarray(gone))
        idx = idx.delete_unchecked(gone)
        total -= gone.shape[0]
        assert_trees_equal(idx.tree, ref.tree, f"step {s} delete")
    assert len(idx) == total == len(ref)
    # rebuild kinds take the checked insert on the dispatch-only path
    unchecked, checked = idx.insert_unchecked(first), idx.insert(first)
    assert_trees_equal(unchecked.tree, checked.tree, "insert_unchecked")


def _tie_free(n: int, q: int, k: int):
    """Points and queries in [0, 2^10) whose k-th and (k+1)-th nearest
    distances differ for every query."""
    for seed in range(64):
        rng = np.random.default_rng(seed)
        pts = rng.integers(0, 1 << 10, size=(n, 2)).astype(np.int32)
        qs = rng.integers(0, 1 << 10, size=(q, 2)).astype(np.int32)
        d2 = np.sort(((pts[None].astype(np.int64) - qs[:, None]) ** 2)
                     .sum(-1), 1)
        if (d2[:, k - 1] != d2[:, k]).all():
            return pts, qs, rng
    raise AssertionError("no tie-free seed found")


@pytest.mark.parametrize("kind", ["kd", "zd"])
def test_engine_answers_bit_equal(kind):
    """kNN through every route and range counts and lists equal the
    reference facade's on tie-free data in [0, 2^10)."""
    pts, qs, rng = _tie_free(700, 16, 3)
    lo = rng.integers(0, 1 << 9, size=(16, 2)).astype(np.int32)
    hi = lo + np.int32(1 << 8)
    kw = dict(max_depth=16) if kind == "kd" else {}
    ref = jindex.make_index(kind, jnp.asarray(pts), phi=PHI, **kw)
    idx = make_index(kind, pts, phi=PHI, device="cpu", **kw)
    d2_w, ids_w = map(np.asarray, ref.knn(jnp.asarray(qs), 3,
                                          impl="frontier"))
    for impl in engine.KNN_IMPLS:
        d2, ids = idx.knn(qs, 3, impl=impl)
        np.testing.assert_array_equal(d2.numpy(), d2_w, err_msg=impl)
        np.testing.assert_array_equal(ids.numpy(), ids_w, err_msg=impl)
    np.testing.assert_array_equal(
        idx.range_count(lo, hi).numpy(),
        np.asarray(ref.range_count(jnp.asarray(lo), jnp.asarray(hi))))
    ids, cnt = idx.range_list(lo, hi)
    ids_r, cnt_r = ref.range_list(jnp.asarray(lo), jnp.asarray(hi))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_r))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_r))


def test_zd_refuses_codes_wider_than_32_bits():
    """3D at the default bits = 15 is a 45-bit code: the reference's
    uint64 case, which the port does not carry."""
    pts = np.zeros((8, 3), np.int32)
    with pytest.raises(ValueError, match="at most 32 bits"):
        baselines.zd_build(torch.as_tensor(pts), phi=PHI)
    with pytest.raises(ValueError, match="at most 32 bits"):
        make_index("zd", pts, phi=PHI, device="cpu")
    assert len(make_index("zd", pts, phi=PHI, device="cpu", bits=10)) == 8
