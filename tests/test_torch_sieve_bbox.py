"""Port parity for the sieve and row-bbox kernels' plain versions.

* ``repro_torch.kernels.sieve.ops.sieve_histogram`` / ``sieve_partition``
  against ``repro.kernels.sieve.ops`` run with ``impl="interpret"`` (the
  Pallas kernel interpreted on the CPU) and ``impl="ref"``, int32 and
  float32, bit-equal;
* the segmented counting sort that orders each P-Orth sieve round,
  against the stable argsort of the reference's ``_sieve_rounds`` on
  states with many segments (bit-equal per-point state after each call);
* ``repro_torch.core.leafstore.row_bbox_from_slots`` against the
  reference twin ``repro.core.leafstore.row_bbox_from_slots``,
  bit-equal in the points' dtype;
* the wrappers' device rule: CPU tensors take the plain versions, any
  device other than CUDA raises (the CUDA launches are in
  ``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import leafstore as jls
from repro.core import porth as jporth
from repro.kernels.sieve import ops as jsieve
from repro_torch.core import leafstore, porth
from repro_torch.kernels.bbox import kernel as bbox_kernel
from repro_torch.kernels.bbox import ops as bbox_ops
from repro_torch.kernels.sieve import kernel as sieve_kernel
from repro_torch.kernels.sieve import ops as sieve_ops

torch.set_num_threads(1)


def _cells(rng, dtype, n: int, dim: int):
    """Points with per-point cell bounds: the root cell for some, a
    random sub-cell (that contains the point) for the rest."""
    if dtype == np.float32:
        pts = rng.random((n, dim)).astype(np.float32)
        lo = np.where(rng.random((n, dim)) < 0.5, 0.0,
                      np.floor(pts * 4) / 4).astype(np.float32)
        return pts, lo, (lo + np.where(lo == 0, 1.0, 0.25)).astype(
            np.float32)
    pts = rng.integers(0, 1 << 20, size=(n, dim)).astype(np.int32)
    side = np.where(rng.random((n, dim)) < 0.5, 1 << 20, 1 << 16)
    lo = (pts // side * side).astype(np.int32)
    return pts, lo, (lo + side).astype(np.int32)


CASES = [(np.int32, 3000, 2, 3, 256), (np.float32, 3000, 2, 3, 1024),
         (np.int32, 900, 3, 2, 128), (np.float32, 900, 3, 2, 4096)]


@pytest.mark.parametrize("dtype,n,dim,lam,block_n", CASES)
@pytest.mark.parametrize("jimpl", ["interpret", "ref"])
def test_histogram_and_partition_match_reference(dtype, n, dim, lam,
                                                 block_n, jimpl):
    rng = np.random.default_rng(n + dim)
    args = _cells(rng, dtype, n, dim)
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.as_tensor(a) for a in args]
    kw = dict(lam=lam, block_n=block_n)
    want = jsieve.sieve_histogram(*jargs, impl=jimpl, **kw)
    got = sieve_ops.sieve_histogram(*targs, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jsieve.sieve_partition(*jargs, impl=jimpl, **kw)
    got = sieve_ops.sieve_partition(*targs, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert sorted(got[0].tolist()) == list(range(n))


def _round_state(rng, dtype, n: int):
    """An insert-shaped 2D sieve state over disjoint seed cells: points of
    every other depth-3 cell seed at that cell, the rest at their depth-6
    cell (so some groups hold more than phi points and some fewer), with
    a masked-out tenth."""
    if dtype == np.float32:
        pts = rng.random((n, 2)).astype(np.float32)
        top = 1.0
    else:
        pts = rng.integers(0, 1 << 20, size=(n, 2)).astype(np.int32)
        top = 1 << 20
    cell3 = np.floor(pts / (top / 8)).astype(np.int64)
    depth = np.where(cell3.sum(1) % 2 == 0, 3, 6).astype(np.int32)
    side = (top / 2.0 ** depth)[:, None]
    lo = (np.floor(pts / side) * side).astype(dtype)
    hi = (lo + side).astype(dtype)
    keys = np.asarray(jporth.point_keys(
        jnp.asarray(pts), jnp.zeros(2, dtype), jnp.full(2, top, dtype),
        lam=3, rounds=5))
    shift = 30 - 2 * depth
    key = (keys >> shift << shift).astype(np.uint32)
    return pts, rng.random(n) > 0.1, lo, hi, key, depth


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_sieve_rounds_segmented_sort_matches_argsort(dtype):
    """Each round's segmented counting sort gives the per-point order of
    the reference's stable argsort over the whole key array."""
    rng = np.random.default_rng(5)
    phi = 4
    state = _round_state(rng, dtype, 1500)
    want = jporth._sieve_rounds(*map(jnp.asarray, state), phi, 3, 5, 15, 30)
    t = [torch.as_tensor(a) for a in state]
    t[4] = t[4].long()
    got = porth._sieve_rounds(*t, phi, 3, 5, 15, 30)
    for name, g, w in zip(("pts", "ok", "lo", "hi", "key", "depth"), got,
                          want):
        np.testing.assert_array_equal(g.numpy().astype(np.asarray(w).dtype),
                                      np.asarray(w), err_msg=name)


def test_segmented_partition_keeps_inactive_points_and_segment_order():
    """Against a composite-key stable argsort: active points ordered by
    (segment, bucket), inactive points left where they are; active points
    get their bucket's cell, inactive ones keep their own."""
    rng = np.random.default_rng(6)
    n, block_n = 700, 32
    pts, lo, hi = (torch.as_tensor(a) for a in _cells(rng, np.int32, n, 2))
    starts = np.concatenate([[0], np.sort(rng.choice(
        np.arange(1, n), size=30, replace=False))])
    which = np.searchsorted(starts, np.arange(n), side="right") - 1
    seg_start = torch.as_tensor(starts[which].astype(np.int32))
    act = torch.as_tensor((rng.random(starts.shape[0]) < 0.6)[which])
    dest, bucket, clo, chi = sieve_ops.segmented_partition(
        pts, lo, hi, seg_start, act, lam=3, block_n=block_n,
        n_chunks=n // block_n + starts.shape[0] + 1)
    key = torch.where(act, seg_start.long() * 64 + bucket.long(),
                      torch.arange(n) * 64)
    order = torch.argsort(key, stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n)
    np.testing.assert_array_equal(dest.numpy(), inv.numpy())
    assert (dest[~act] == torch.arange(n)[~act]).all()
    assert (bucket[~act] == 0).all() and bool(act.any())
    # the bucket's cell, against the reference's skeleton descent
    want_b, want_lo, want_hi = (np.asarray(w) for w in
                                jporth._split_lambda_levels(
                                    *(jnp.asarray(t.numpy())
                                      for t in (pts, lo, hi)), 3, 2))
    a = act.numpy()
    np.testing.assert_array_equal(bucket.numpy()[a], want_b[a])
    for got, want, own in ((clo, want_lo, lo), (chi, want_hi, hi)):
        np.testing.assert_array_equal(
            got.numpy(), np.where(a[:, None], want, own.numpy()))


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_row_bbox_matches_reference_twin(dtype):
    rng = np.random.default_rng(7)
    R, C, D = 50, 16, 3
    if dtype == np.float32:
        pts = rng.standard_normal((R, C, D)).astype(np.float32)
    else:
        pts = rng.integers(-(1 << 30), 1 << 30, size=(R, C, D)).astype(
            np.int32)
    valid = rng.random((R, C)) > 0.6
    valid[:3] = False                   # empty rows get the sentinels
    want = jls.row_bbox_from_slots(jnp.asarray(pts), jnp.asarray(valid))
    got = leafstore.row_bbox_from_slots(torch.as_tensor(pts),
                                        torch.as_tensor(valid))
    plain = bbox_ops.row_bbox_plain(torch.as_tensor(pts),
                                    torch.as_tensor(valid))
    for g, p, w in zip(got, plain, want):
        assert g.dtype == torch.from_numpy(pts).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(p.numpy(), np.asarray(w))


def test_wrappers_take_plain_on_cpu_and_refuse_other_devices():
    pts = torch.zeros((4, 2, 2), dtype=torch.int32)
    valid = torch.ones((4, 2), dtype=torch.bool)
    before = bbox_kernel.launch_count()
    bbox_kernel.row_bbox(pts, valid)
    assert bbox_kernel.launch_count() == before
    with pytest.raises(ValueError, match="unsupported device"):
        bbox_kernel.row_bbox(pts.to("meta"), valid.to("meta"))
    p = torch.zeros((8, 2), dtype=torch.int32)
    cs = torch.zeros(1, dtype=torch.int32)
    cl = torch.full((1,), 8, dtype=torch.int32)
    before = sieve_kernel.launch_count()
    hist = sieve_kernel.sieve_histogram_chunks(p, p, p + 8, cs, cl, lam=1)
    assert hist.tolist() == [[8, 0, 0, 0]]
    assert sieve_kernel.launch_count() == before
    with pytest.raises(ValueError, match="unsupported device"):
        sieve_kernel.sieve_histogram_chunks(
            *(t.to("meta") for t in (p, p, p, cs, cl)), lam=1)
