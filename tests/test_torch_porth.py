"""Port parity: ``repro_torch.core.porth`` against ``repro.core.porth``.

Every ``POrthTree`` field -- the directory ``order``, the cell keys (as
uint32 through ``POrthTree.to_numpy``) and the sticky ``overflowed``
flag included -- must be bit-equal to the reference's after the build
and after each step of an insert/delete trace, for tie-free integers,
duplicate-heavy input (cells saturated across several rows, so the
delete walks directory bands), float32 coordinates in [0, 1) and 3D with
lam = 2. On top of the trees: queries on porth views through every kNN
route and the range paths, the ``porth`` backend behind ``make_index``
(build and the grow -> retry -> compact ladder) and ``SpatialServer``
(snapshot isolation with updates in flight, micro-batched answers),
each against the reference's facade or server.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import index as jindex
from repro.core import porth as jporth
from repro.serving import MicroBatcher as JBatcher
from repro.serving import SpatialServer as JServer
from repro_torch.core import engine, make_index, porth
from repro_torch.serving import MicroBatcher, SpatialServer

torch.set_num_threads(1)

PHI, STEPS, BATCH = 8, 3, 160
HI = 1 << 20


def ref_fields(tree) -> dict:
    return {f: np.asarray(getattr(tree, f)) for f in porth.FIELDS}


def assert_trees_equal(port_tree, ref_tree, where: str):
    got, want = port_tree.to_numpy(), ref_fields(ref_tree)
    for f in porth.FIELDS:
        assert got[f].dtype == want[f].dtype, (where, f)
        np.testing.assert_array_equal(got[f], want[f],
                                      err_msg=f"{where}: field {f}")


def _case(name: str, rng):
    """(points, batches, root_lo, root_hi, lam) for a named input."""
    if name == "float32":
        pts = rng.random((800, 2)).astype(np.float32)
        new = [rng.random((BATCH, 2)).astype(np.float32)
               for _ in range(STEPS)]
        return pts, new, np.zeros(2, np.float32), np.ones(2, np.float32), 3
    dim = 3 if name == "3d" else 2
    if name == "duplicates":
        # 9 distinct points, each alone in its deepest cell (side 32):
        # ~130 copies saturate a cell across ~17 rows of C = 16
        def draw(n):
            return (64 * rng.integers(0, 3, size=(n, 2))).astype(np.int32)
    else:
        def draw(n):
            return rng.integers(0, HI, size=(n, dim)).astype(np.int32)
    n = 1000 if name == "3d" else 1200
    return (draw(n), [draw(BATCH) for _ in range(STEPS)],
            np.zeros(dim, np.int32), np.full(dim, HI, np.int32),
            2 if dim == 3 else 3)


@pytest.mark.parametrize("name", ["tie-free", "duplicates", "float32",
                                  "3d"])
def test_fields_bit_equal_along_trace(name):
    rng = np.random.default_rng(11)
    pts, batches, root_lo, root_hi, lam = _case(name, rng)
    kw = dict(phi=PHI, lam=lam, rounds=5, capacity_rows=3 * pts.shape[0])
    ref = jporth.build(jnp.asarray(pts), jnp.asarray(root_lo),
                       jnp.asarray(root_hi), **kw)
    got = porth.build(torch.as_tensor(pts), torch.as_tensor(root_lo),
                      torch.as_tensor(root_hi), **kw)
    assert_trees_equal(got, ref, "build")
    for s, new in enumerate(batches):
        dele = pts[s * BATCH: (s + 1) * BATCH]
        ref = jporth.delete(ref, jnp.asarray(dele))
        got = porth.delete(got, torch.as_tensor(dele))
        assert_trees_equal(got, ref, f"step {s} delete")
        ref = jporth.insert(ref, jnp.asarray(new))
        got = porth.insert(got, torch.as_tensor(new))
        assert_trees_equal(got, ref, f"step {s} insert")
    assert int(got.size) == pts.shape[0] and not bool(got.overflowed)
    if name == "duplicates":   # bands of several rows per cell
        keys = got.cell_key[got.active]
        assert int(torch.unique(keys, return_counts=True)[1].max()) > 4


def test_reference_shared_cell_delete_anomaly_is_reproduced():
    """Distinct points that share a deepest cell (side 32 here) are not
    contiguous in the delete's key-sorted batch, so the reference's
    window-C rank among equals misses copies: deleting 160 of 1200
    points drawn from {100, 101, 102}^2 leaves 1123 live, not 1040. The
    port reproduces the reference's tree, live count included."""
    rng = np.random.default_rng(17)
    pts = (100 + rng.integers(0, 3, size=(1200, 2))).astype(np.int32)
    root = (np.zeros(2, np.int32), np.full(2, HI, np.int32))
    kw = dict(phi=PHI, lam=3, rounds=5, capacity_rows=3600)
    ref = jporth.build(jnp.asarray(pts), *map(jnp.asarray, root), **kw)
    got = porth.build(torch.as_tensor(pts), *map(torch.as_tensor, root),
                      **kw)
    ref = jporth.delete(ref, jnp.asarray(pts[:BATCH]))
    got = porth.delete(got, torch.as_tensor(pts[:BATCH]))
    assert_trees_equal(got, ref, "delete")
    assert int(got.size) == int(ref.size) == 1123


def test_merge_pass_merges_sibling_leaves():
    """Keep only the points of sibling leaves (rows at depth 6 that share
    their depth-5 prefix) and delete the rest: the delete's merge pass
    moves them up to their parent cell (one level, not one sieve round),
    as the reference does. The reference re-chunks the merged rows' slots
    in row order, so each row's invalid slots end a run and the rows come
    back as a band of the parent cell rather than one row; the port keeps
    that."""
    rng = np.random.default_rng(12)
    pts = rng.integers(0, HI, size=(1200, 2)).astype(np.int32)
    root = (np.zeros(2, np.int32), np.full(2, HI, np.int32))
    ref = jporth.build(jnp.asarray(pts), *map(jnp.asarray, root), phi=PHI,
                       capacity_rows=3600)
    got = porth.build(torch.as_tensor(pts), *map(torch.as_tensor, root),
                      phi=PHI, capacity_rows=3600)
    parent = got.cell_key >> (got.key_bits - 5 * 2)
    at6 = got.active & (got.cell_depth == 6)
    keys, n_rows = torch.unique(parent[at6], return_counts=True)
    rows = at6 & (parent == keys[n_rows >= 2][0])
    kept = got.pts[rows][got.valid[rows]].numpy()
    gone = ~(pts[:, None, :] == kept[None]).all(-1).any(1)
    ref = jporth.delete(ref, jnp.asarray(pts[gone]))
    got = porth.delete(got, torch.as_tensor(pts[gone]))
    assert_trees_equal(got, ref, "delete")
    n_rows = int(rows.sum())
    assert n_rows >= 2 and int(got.num_rows) == n_rows
    assert (got.cell_depth[got.active] == 5).all()
    assert torch.unique(got.cell_key[got.active]).numel() == 1
    assert int(got.size) == kept.shape[0]
    assert_trees_equal(porth.merge_pass(got), jporth.merge_pass(ref),
                       "second pass")


def test_all_or_nothing_insert_and_carry_over():
    """A tree built by JAX, carried over with ``from_numpy``, takes the
    same updates; a small ``max_overflow_rows`` makes an insert fail
    all-or-nothing with the sticky flag, as in the reference."""
    rng = np.random.default_rng(13)
    pts = rng.integers(0, 4, size=(600, 2)).astype(np.int32)
    root = (jnp.zeros(2, jnp.int32), jnp.full(2, 4, jnp.int32))
    ref = jporth.build(jnp.asarray(pts), *root, phi=PHI, lam=2, rounds=1,
                       capacity_rows=400)
    got = porth.POrthTree.from_numpy(ref_fields(ref), dict(
        phi=ref.phi, lam=ref.lam, rounds=ref.rounds), "cpu")
    assert got.cell_key.dtype == torch.int64
    assert got.meta == dict(phi=PHI, lam=2, rounds=1)
    assert_trees_equal(got, ref, "carried over")
    ins = rng.integers(0, 4, size=(300, 2)).astype(np.int32)
    for mor in (64, 1):
        r2 = jporth.insert(ref, jnp.asarray(ins), max_overflow_rows=mor)
        g2 = porth.insert(got, torch.as_tensor(ins), max_overflow_rows=mor)
        assert_trees_equal(g2, r2, f"insert mor={mor}")
        assert bool(g2.overflowed) == (mor == 1)
    assert int(g2.size) == 600


def test_point_keys_grow_compact_and_free_rows():
    rng = np.random.default_rng(14)
    pts = rng.integers(0, HI, size=(500, 2)).astype(np.int32)
    root = (np.zeros(2, np.int32), np.full(2, HI, np.int32))
    np.testing.assert_array_equal(
        porth.point_keys(torch.as_tensor(pts), *map(torch.as_tensor, root),
                         lam=3, rounds=5).numpy().astype(np.uint32),
        np.asarray(jporth.point_keys(jnp.asarray(pts),
                                     *map(jnp.asarray, root), lam=3,
                                     rounds=5)))
    ref = jporth.build(jnp.asarray(pts), *map(jnp.asarray, root), phi=PHI,
                       capacity_rows=800)
    got = porth.build(torch.as_tensor(pts), *map(torch.as_tensor, root),
                      phi=PHI, capacity_rows=800)
    assert_trees_equal(porth.grow(got, 1000), jporth.grow(ref, 1000), "grow")
    assert porth.grow(got, 100) is got
    assert porth.free_rows(got) == jporth.free_rows(ref)
    assert_trees_equal(porth.compact(got, 900), jporth.compact(ref, 900),
                       "compact")


# ---------------------------------------------------------------------------
# queries, the facade and the server
# ---------------------------------------------------------------------------

def _tie_free(dtype, n: int, q: int, k: int):
    for seed in range(64):
        rng = np.random.default_rng(seed)
        if dtype == np.float32:
            pts = rng.random((n, 2)).astype(np.float32)
            qs = rng.random((q, 2)).astype(np.float32)
        else:
            pts = rng.integers(0, 1 << 10, size=(n, 2)).astype(np.int32)
            qs = rng.integers(0, 1 << 10, size=(q, 2)).astype(np.int32)
        d2 = np.sort(((pts[None].astype(np.float64)
                       - qs[:, None]) ** 2).sum(-1), 1)
        if (d2[:, k - 1] != d2[:, k]).all():
            return pts, qs
    raise AssertionError("no tie-free seed found")


def _direct_d2(pts, qs, ids):
    """The direct f32 form (q0 - p0)^2 + (q1 - p1)^2, each operation
    rounded, as the port's routes and kernels compute it."""
    p = pts.reshape(-1, 2)[ids]
    d0, d1 = qs[:, None, 0] - p[..., 0], qs[:, None, 1] - p[..., 1]
    return d0 * d0 + d1 * d1


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_queries_bit_equal_through_every_route(dtype):
    """kNN ids and range answers bit-equal to the reference facade's on
    every route. Integer distances are exact in f32, so d2 is bit-equal
    too; on float32 data the reference's XLA CPU code fuses the
    multiply-add, so its d2 may differ from the port's rounded direct
    form in the last bit: there d2 equals a numpy evaluation of the
    direct form bit for bit and the reference's within rtol 1e-6."""
    k = 5
    pts, qs = _tie_free(dtype, 700, 16, k)
    ref = jindex.make_index("porth", jnp.asarray(pts), phi=PHI)
    idx = make_index("porth", pts, phi=PHI, device="cpu")
    assert_trees_equal(idx.tree, ref.tree, "make_index")
    d2_w, ids_w = map(np.asarray, ref.knn(jnp.asarray(qs), k,
                                          impl="frontier"))
    flat = idx.view().pts.numpy()
    for impl in engine.KNN_IMPLS:
        d2, ids = idx.knn(qs, k, impl=impl)
        np.testing.assert_array_equal(ids.numpy(), ids_w, err_msg=impl)
        if dtype == np.int32:
            np.testing.assert_array_equal(d2.numpy(), d2_w, err_msg=impl)
        else:
            np.testing.assert_array_equal(
                d2.numpy(), _direct_d2(flat, qs, ids_w), err_msg=impl)
            np.testing.assert_allclose(d2.numpy(), d2_w, rtol=1e-6,
                                       err_msg=impl)
    span = (1 << 8) if dtype == np.int32 else 0.25
    lo = (qs - span / 2).astype(dtype)
    hi = (qs + span / 2).astype(dtype)
    np.testing.assert_array_equal(
        idx.range_count(lo, hi).numpy(),
        np.asarray(ref.range_count(jnp.asarray(lo), jnp.asarray(hi))))
    ids, cnt = idx.range_list(lo, hi)
    ids_r, cnt_r = ref.range_list(jnp.asarray(lo), jnp.asarray(hi))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_r))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_r))


def test_facade_recovery_ladder_bit_equal():
    """Inserting far past capacity goes through grow -> retry (->
    compact) as the reference facade does; nothing is lost."""
    rng = np.random.default_rng(15)
    pts = rng.integers(0, HI, size=(600, 2)).astype(np.int32)
    ref = jindex.make_index("porth", jnp.asarray(pts), phi=PHI)
    idx = make_index("porth", pts, phi=PHI, device="cpu")
    assert idx.capacity_rows == ref.capacity_rows
    cap = idx.capacity_rows
    batch = rng.integers(0, HI, size=(3000, 2)).astype(np.int32)
    assert bool(idx.insert_unchecked(batch).tree.overflowed)
    ref = ref.insert(jnp.asarray(batch))
    idx = idx.insert(batch)
    assert_trees_equal(idx.tree, ref.tree, "insert")
    total = 3600
    assert len(idx) == total and idx.capacity_rows > cap
    gone = idx.delete(pts[:100])
    assert_trees_equal(gone.tree, ref.delete(jnp.asarray(pts[:100])).tree,
                       "delete")
    assert len(gone) == total - 100 and len(idx) == total


def test_trace_through_both_servers():
    """The pipelined serving pattern over porth on both stacks: answers
    against the pre-step snapshot (updates in flight) and every field
    after every commit bit-equal. Coordinates < 2^11 keep every squared
    distance exact in f32."""
    rng = np.random.default_rng(16)
    hi, k, q = 1 << 11, 5, 16
    boot = rng.integers(0, hi, size=(2000, 2)).astype(np.int32)
    kw = dict(phi=PHI, capacity_points=2400)
    ref = JServer.build("porth", jnp.asarray(boot), **kw)
    srv = SpatialServer.build("porth", boot, device="cpu", **kw)
    jmb = JBatcher(max_batch=q, max_delay_s=1e9)
    mb = MicroBatcher(max_batch=q, max_delay_s=1e9)
    live = boot
    for _ in range(2):
        jsnap, snap = ref.snapshot(), srv.snapshot()
        jmb.target, mb.target = jsnap, snap
        dele = live[:128]
        ins = rng.integers(0, hi, size=(128, 2)).astype(np.int32)
        live = np.concatenate([live[128:], ins])
        ref.delete(jnp.asarray(dele))
        srv.delete(dele)
        ref.insert(jnp.asarray(ins))
        srv.insert(ins)
        assert srv.in_flight == 2 and len(snap) == len(jsnap)
        qs = rng.integers(0, hi, size=(q, 2)).astype(np.int32)
        lo = rng.integers(0, hi - 256, size=(q, 2)).astype(np.int32)
        up = lo + rng.integers(0, 256, size=(q, 2)).astype(np.int32)
        want = [jmb.submit_knn(p, k) for p in qs]
        got = [mb.submit_knn(p, k) for p in qs]
        want_c = [jmb.submit_range_count(a, b) for a, b in zip(lo, up)]
        got_c = [mb.submit_range_count(a, b) for a, b in zip(lo, up)]
        for w, g in zip(want, got):
            for wa, ga in zip(w.result(), g.result()):
                np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
        np.testing.assert_array_equal(
            np.concatenate([g.result().numpy() for g in got_c]),
            np.concatenate([np.asarray(w.result()) for w in want_c]))
        assert ref.commit() == srv.commit()
        assert_trees_equal(srv.head_index.tree, ref.head_index.tree,
                           "commit")
    assert len(srv.head_index) == len(ref.head_index) == 2000
    assert srv.stats == ref.stats
