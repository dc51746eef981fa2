"""Port parity: ``repro_torch.core.spac`` against ``repro.core.spac``.

Every ``SpacTree`` field -- the ``unsorted`` partial-order flags, the
directory ``order`` and the sticky ``overflowed`` flag included -- must be
bit-equal to the reference's after the build and after each step of a
``repro.data.points.make_trace`` trace. Codes compare as uint32 through
``SpacTree.to_numpy``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import spac as jspac
from repro.core.index import capacity_for
from repro.data import points as jgen
from repro_torch.core import spac

torch.set_num_threads(1)

PHI = 8


def ref_fields(tree) -> dict:
    return {f: np.asarray(getattr(tree, f)) for f in spac.FIELDS}


def assert_trees_equal(port_tree, ref_tree, where: str):
    got, want = port_tree.to_numpy(), ref_fields(ref_tree)
    for f in spac.FIELDS:
        assert got[f].dtype == want[f].dtype, (where, f)
        np.testing.assert_array_equal(got[f], want[f],
                                      err_msg=f"{where}: field {f}")


def _steps(trace):
    for s, step in enumerate(trace.steps):
        yield s, np.asarray(step.delete), np.asarray(step.insert)


@pytest.mark.parametrize("scenario,curve,sort_rows,dim", [
    ("uniform", "hilbert", False, 2),
    ("varden", "morton", False, 2),
    ("sweepline", "hilbert", True, 2),
    ("moving-objects", "hilbert", False, 2),
    ("uniform", "hilbert", False, 3),
])
def test_fields_bit_equal_along_trace(scenario, curve, sort_rows, dim):
    trace = jgen.make_trace(scenario, seed=3, n=1200, batch=160, steps=3,
                            dim=dim)
    boot = np.asarray(trace.bootstrap)
    bits = 16 if dim == 2 else 10          # codes of at most 32 bits
    meta = dict(phi=PHI, curve=curve, bits=bits, coord_bits=20)
    rows = capacity_for(trace.max_live, PHI)
    ref = jspac.build(jnp.asarray(boot), capacity_rows=rows, **meta)
    got = spac.build(torch.as_tensor(boot), capacity_rows=rows, **meta)
    assert_trees_equal(got, ref, "build")
    assert not got.unsorted.any()
    live = boot.shape[0]
    for s, dele, ins in _steps(trace):
        live += ins.shape[0] - dele.shape[0]
        ref = jspac.delete(ref, jnp.asarray(dele))
        got = spac.delete(got, torch.as_tensor(dele))
        assert_trees_equal(got, ref, f"step {s} delete")
        ref = jspac.insert(ref, jnp.asarray(ins), sort_rows=sort_rows)
        got = spac.insert(got, torch.as_tensor(ins), sort_rows=sort_rows)
        assert_trees_equal(got, ref, f"step {s} insert")
        assert bool(got.unsorted.any()) == (not sort_rows)
    assert int(got.size) == live


def test_duplicate_bands_and_all_or_nothing_insert():
    """Heavy duplicates make equal-code runs span several rows (the
    delete's band walk takes several rounds), and a small
    ``max_overflow_rows`` makes an insert fail all-or-nothing: the old
    fields come back with ``overflowed`` set, as in the reference.
    (``coord_bits == bits`` keeps distinct points on distinct codes, so
    equal points are contiguous in the sorted batch, which the ranked
    match relies on.)"""
    rng = np.random.default_rng(5)
    boot = rng.integers(0, 3, size=(700, 2)).astype(np.int32)
    meta = dict(phi=PHI, curve="hilbert", bits=16, coord_bits=16)
    ref = jspac.build(jnp.asarray(boot), capacity_rows=400, **meta)
    got = spac.build(torch.as_tensor(boot), capacity_rows=400, **meta)
    dele = np.concatenate([boot[:150], boot[:40], [[7, 7]]]).astype(np.int32)
    ref = jspac.delete(ref, jnp.asarray(dele))
    got = spac.delete(got, torch.as_tensor(dele))
    assert_trees_equal(got, ref, "duplicate delete")
    assert int(got.size) == 700 - 190
    ins = rng.integers(0, 3, size=(300, 2)).astype(np.int32)
    for mor in (64, 2):
        r2 = jspac.insert(ref, jnp.asarray(ins), max_overflow_rows=mor)
        g2 = spac.insert(got, torch.as_tensor(ins), max_overflow_rows=mor)
        assert_trees_equal(g2, r2, f"insert mor={mor}")
        assert bool(g2.overflowed) == (mor == 2)


def test_from_numpy_round_trip_and_updates_on_both_sides():
    """A tree built by JAX, carried over with ``from_numpy``, takes the
    same updates as the reference; ``to_numpy`` gives the reference's
    fields back (uint32 codes)."""
    rng = np.random.default_rng(6)
    boot = rng.integers(0, 1 << 20, size=(900, 2)).astype(np.int32)
    ref = jspac.build(jnp.asarray(boot), phi=PHI, capacity_rows=500)
    meta = dict(phi=ref.phi, curve=ref.curve, bits=ref.bits,
                coord_bits=ref.coord_bits)
    got = spac.SpacTree.from_numpy(ref_fields(ref), meta, "cpu")
    assert got.codes.dtype == torch.int64 and got.meta == meta
    assert_trees_equal(got, ref, "carried over")
    ins = rng.integers(0, 1 << 20, size=(200, 2)).astype(np.int32)
    ref = jspac.insert(ref, jnp.asarray(ins))
    got = spac.insert(got, torch.as_tensor(ins))
    assert_trees_equal(got, ref, "insert after carry-over")
    ref = jspac.delete(ref, jnp.asarray(boot[::3]))
    got = spac.delete(got, torch.as_tensor(boot[::3]))
    assert_trees_equal(got, ref, "delete after carry-over")


def test_grow_and_compact():
    rng = np.random.default_rng(7)
    boot = rng.integers(0, 1 << 20, size=(400, 2)).astype(np.int32)
    ref = jspac.build(jnp.asarray(boot), phi=PHI, capacity_rows=120)
    got = spac.build(torch.as_tensor(boot), phi=PHI, capacity_rows=120)
    ref = jspac.delete(ref, jnp.asarray(boot[:100]))
    got = spac.delete(got, torch.as_tensor(boot[:100]))
    assert_trees_equal(spac.grow(got, 200), jspac.grow(ref, 200), "grow")
    assert spac.grow(got, 100) is got
    assert_trees_equal(spac.compact(got, 160), jspac.compact(ref, 160),
                       "compact")


def test_reference_duplicate_delete_anomaly_is_reproduced():
    """The reference's delete can leave copies live when several rows
    share a ``min_code`` (``tests/test_properties.py::
    test_spac_knn_exact_after_updates`` fails on such inputs at random).
    One deterministic input of that kind, at the property test's
    settings: 96 points drawn from 3 distinct points in [100, 110], 32
    inserts at the origin, then a delete of the first 32 points. The
    port's tree must equal the reference's field for field, live count
    included, whatever that count is (98 here, not 96)."""
    pts = np.array([[101, 100], [103, 105]] + [[100, 100]] * 94, np.int32)
    ins = np.zeros((32, 2), np.int32)
    meta = dict(phi=PHI, curve="hilbert", bits=12, coord_bits=12)
    ref = jspac.build(jnp.asarray(pts), capacity_rows=256, **meta)
    got = spac.build(torch.as_tensor(pts), capacity_rows=256, **meta)
    ref = jspac.delete(jspac.insert(ref, jnp.asarray(ins)),
                       jnp.asarray(pts[:32]))
    got = spac.delete(spac.insert(got, torch.as_tensor(ins)),
                      torch.as_tensor(pts[:32]))
    assert_trees_equal(got, ref, "insert + delete")
    assert int(got.size) == int(ref.size)


def test_spac_delete_shortfall_at_128_points_matches_reference():
    """The example hypothesis found for ``tests/test_properties.py::
    test_spac_knn_exact_after_updates``: 96 points, one at (0, 1) and 95 at
    (1, 1), 32 inserts at the origin, then a delete of the first 32
    points. 96 points are due live; the reference leaves 97 (its delete
    shortfall, ROADMAP queue 3). The port's live count and live points
    (as a multiset) equal the reference's, and its tree field for
    field."""
    pts = np.array([[0, 1]] + [[1, 1]] * 95, np.int32)
    ins = np.zeros((32, 2), np.int32)
    meta = dict(phi=PHI, curve="hilbert", bits=12, coord_bits=12)
    ref = jspac.build(jnp.asarray(pts), capacity_rows=256, **meta)
    got = spac.build(torch.as_tensor(pts), capacity_rows=256, **meta)
    ref = jspac.delete(jspac.insert(ref, jnp.asarray(ins)),
                       jnp.asarray(pts[:32]))
    got = spac.delete(spac.insert(got, torch.as_tensor(ins)),
                      torch.as_tensor(pts[:32]))
    assert_trees_equal(got, ref, "insert + delete")
    assert int(got.size) == int(ref.size) == 97

    def live(points, ok):
        points = np.asarray(points)[np.asarray(ok)]
        return points[np.lexsort(points.T[::-1])]

    want = live(*jspac.extract_points(ref))
    have = live(*(t.numpy() for t in spac.extract_points(got)))
    assert len(want) == 97
    np.testing.assert_array_equal(have, want)
