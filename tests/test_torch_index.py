"""Port parity: the ``repro_torch.core.index`` facade against
``repro.core.index``: registry and errors, the capacity policy, builds
and the grow -> retry -> compact recovery ladder (trees bit-equal to the
reference facade's), and queries through the facade."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import index as jindex
from repro_torch import obs
from repro_torch.configs.platform import simulate_mesh
from repro_torch.core import (BACKENDS, baselines, get_backend, index,
                              make_index, porth, spac)

torch.set_num_threads(1)

PHI = 8
RNG = np.random.default_rng(0)
PTS = RNG.integers(0, 1 << 20, size=(600, 2)).astype(np.int32)


def _fields(kind: str) -> tuple:
    if kind in ("kd", "zd"):
        return baselines.FIELDS
    return porth.FIELDS if kind == "porth" else spac.FIELDS


def assert_same_tree(idx, ref_idx):
    got = idx.tree.to_numpy()
    for f in _fields(idx.kind):
        np.testing.assert_array_equal(got[f],
                                      np.asarray(getattr(ref_idx.tree, f)),
                                      err_msg=f)


def test_registry_and_errors():
    assert sorted(BACKENDS) == sorted(jindex.BACKENDS) == [
        "cpam-h", "cpam-z", "kd", "porth", "spac-h", "spac-m", "spac-z",
        "zd"]
    with pytest.raises(KeyError, match="registered"):
        make_index("octree", PTS, device="cpu")
    with pytest.raises(TypeError, match="unknown params"):
        make_index("spac-h", PTS, device="cpu", lam=3)
    # mesh= gives the distributed facade (the mesh-capable kinds only)
    mesh = simulate_mesh(2, device="cpu")
    assert isinstance(make_index("spac-h", PTS, phi=PHI, mesh=mesh),
                      index.DistributedIndex)
    with pytest.raises(ValueError, match="mesh-capable"):
        make_index("kd", PTS, mesh=mesh)


@pytest.mark.parametrize("kind,dynamic", [("kd", False), ("zd", False),
                                         ("porth", True)])
def test_kinds_not_ported_yet_raise(kind, dynamic):
    """The kinds the earlier slices left out are ported now (the name is
    kept from then): kd and zd build as rebuild backends, porth as a
    dynamic one, each with the reference backend's update style."""
    assert get_backend(kind).dynamic is dynamic
    assert jindex.get_backend(kind).dynamic is dynamic
    assert len(make_index(kind, PTS, phi=PHI, device="cpu")) == 600


@pytest.mark.parametrize("n", [0, 1, 31, 10_000, 10 ** 7])
def test_capacity_policy_matches_reference(n):
    assert index.capacity_for(n, PHI) == jindex.capacity_for(n, PHI)
    assert index._round_capacity(n) == jindex._round_capacity(n)


@pytest.mark.parametrize("kind", sorted(BACKENDS))
def test_build_bit_equal(kind):
    ref = jindex.make_index(kind, jnp.asarray(PTS), phi=PHI)
    idx = make_index(kind, PTS, phi=PHI, device="cpu")
    assert_same_tree(idx, ref)
    assert len(idx) == 600 and idx.capacity_rows == ref.capacity_rows
    assert idx.nbytes == sum(getattr(idx.tree, f).nbytes
                             for f in _fields(kind))


def test_tiny_explicit_capacity_build_retries():
    idx = make_index("spac-h", PTS, phi=PHI, capacity_rows=4,
                     device="cpu")
    assert len(idx) == 600
    assert idx.capacity_rows == jindex.make_index(
        "spac-h", jnp.asarray(PTS), phi=PHI, capacity_rows=4).capacity_rows


def test_recovery_ladder_bit_equal():
    """Inserting far past capacity goes through grow -> retry (->
    compact) exactly as the reference facade does: the recovered trees
    are bit-equal and nothing is lost. (``coord_bits=20`` matches the
    data's [0, 2^20) domain, so distinct points get distinct codes.)"""
    ref = jindex.make_index("spac-z", jnp.asarray(PTS), phi=PHI,
                            coord_bits=20)
    idx = make_index("spac-z", PTS, phi=PHI, device="cpu", coord_bits=20)
    rng = np.random.default_rng(1)
    total = 600
    for _ in range(3):
        batch = rng.integers(0, 1 << 20, size=(1500, 2)).astype(np.int32)
        ref = ref.insert(jnp.asarray(batch))
        idx = idx.insert(batch)
        total += 1500
        assert_same_tree(idx, ref)
    assert len(idx) == total and not bool(idx.tree.overflowed)
    gone = idx.delete(PTS[:100])
    assert_same_tree(gone, ref.delete(jnp.asarray(PTS[:100])))
    assert len(gone) == total - 100 and len(idx) == total   # functional


@pytest.mark.parametrize("kind,n,m", [("spac-h", 4000, 6000),
                                      ("porth", 40_000, 40_000)])
def test_ladder_covers_the_split_rows_without_growing(kind, n, m):
    """An insert that splits more rows than ``max_overflow_rows`` while
    :func:`capacity_for` still covers the live points is retried at the
    same capacity with the rows it splits (``Backend.overflow_rows``,
    which is tight: one row fewer fails). The tree is bit-equal to the
    reference facade's given those rows; the reference's own ladder
    would double the capacity. (P-Orth leaves hold a point or two, so it
    takes more points than spac to split that many rows.)"""
    rng = np.random.default_rng(3)
    pts = rng.integers(0, 1 << 20, size=(n, 2)).astype(np.int32)
    batch = rng.integers(0, 1 << 20, size=(m, 2)).astype(np.int32)
    kw = dict(phi=PHI, capacity_points=4 * (n + m),
              **({} if kind == "porth" else {"coord_bits": 20}))
    idx = make_index(kind, pts, device="cpu", **kw)
    new = torch.as_tensor(batch)
    split = int(get_backend(kind).overflow_rows(idx.tree, new))
    assert split > 64
    mod = porth if kind == "porth" else spac
    for rows, fails in ((split - 1, True), (split, False)):
        out = mod.insert(idx.tree, new, max_overflow_rows=rows)
        assert bool(out.overflowed) is fails
    got = idx.insert(batch)
    assert got.capacity_rows == idx.capacity_rows and len(got) == n + m
    ref = jindex.make_index(kind, jnp.asarray(pts), max_overflow_rows=split,
                            **kw).insert(jnp.asarray(batch))
    assert_same_tree(got, ref)


def test_ladder_drops_a_compaction_that_does_not_fit():
    """P-Orth at phi=32 under the figures' incremental procedure (half
    built at the capacity for all, the rest inserted in batches): the
    last insert needs more rows than :func:`capacity_for` gives, so the
    compaction at the same capacity does not fit; the ladder drops it,
    grows, and every point stays."""
    pts = np.random.default_rng(4).integers(
        0, 1 << 20, size=(4000, 2)).astype(np.int32)
    idx = make_index("porth", pts[:2000], phi=32, capacity_points=4000,
                     device="cpu")
    rows = idx.capacity_rows
    with obs.recording(obs.Recorder()) as rec:
        for b in range(2000, 4000, 400):
            idx = idx.insert(pts[b: b + 400])
    assert rec.counters["index.compact"] >= 2 and idx.capacity_rows > rows
    live, ok = idx.extract_points()
    got = live[ok].numpy()
    np.testing.assert_array_equal(got[np.lexsort(got.T)],
                                  pts[np.lexsort(pts.T)])


def test_insert_unchecked_keeps_the_sticky_flag():
    idx = make_index("spac-h", PTS, phi=PHI, device="cpu")
    batch = RNG.integers(0, 1 << 20, size=(5000, 2)).astype(np.int32)
    out = idx.insert_unchecked(batch)
    assert bool(out.tree.overflowed) and len(out) == 600
    assert len(idx.insert(batch)) == 5600


def test_facade_queries():
    idx = make_index("spac-h", PTS, phi=PHI, device="cpu")
    qs = PTS[:4]
    d2, nbrs, ok = idx.knn_points(qs, 3)
    assert (d2[:, 0] == 0).all() and ok.all()
    np.testing.assert_array_equal(nbrs[:, 0].numpy(), qs)
    lo = np.zeros((1, 2), np.int32)
    hi = np.full((1, 2), (1 << 20) - 1, np.int32)
    assert int(idx.range_count(lo, hi)[0]) == 600
    ids, cnt = idx.range_list(lo, hi)
    assert int(cnt[0]) == 600 and int((ids >= 0).sum()) == 600
    pts, ok = idx.extract_points()
    assert int(ok.sum()) == 600
    assert idx.block_until_ready() is idx
