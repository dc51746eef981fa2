"""The sieve round's decomposition on the CPU.

``repro_torch.kernels.sieve.ref.sieve_round_plain`` spells what the CUDA
round (``csrc/sieve.cu``) computes: a chunk pass that sorts segments of
at most ``block_n`` active points ("single") from longer ones cut into
``block_n``-point chunks ("multi"), counts each kind in use, sorts a
single segment in one pass, and scans the multi chunks' bucket counts
over the chunks in use. Here it is held bit for bit against

* the CPU route of ``ops.segmented_partition`` (chunk tables, histograms,
  ``chunk_offsets``, ranks),
* a composite-key stable argsort by (segment, bucket), and the
  reference's ``_split_lambda_levels`` for buckets and cells,
* the reference's ``repro.core.porth._sieve_rounds`` (JAX), with the
  mirror in place of every round of the port's ``_sieve_rounds``,

on every segment layout the round routes differently: all single
segments of 33-64 points, segments of exactly ``block_n`` and
``block_n + 1`` points, one segment of many chunks, no active point;
int32 and float32, D = 1, 2, 3, and lam * D = 10.

    PYTHONPATH=src python -m pytest -q tests/test_torch_sieve_round.py
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import porth as jporth
from repro_torch.core import porth
from repro_torch.kernels.sieve import kernel as sk
from repro_torch.kernels.sieve import ops as sieve_ops
from repro_torch.kernels.sieve import ref as sieve_ref

torch.set_num_threads(1)


def _points(rng, dtype, n: int, dim: int):
    """Points with their cells: the root cell or a sub-cell holding the
    point."""
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


def _layout(rng, name: str, block_n: int):
    """Segment lengths and which segments are active."""
    B = block_n
    if name == "singles":         # every segment one chunk of 33-64
        lens = rng.integers(33, 65, 40)
        act = rng.random(40) < 0.8
    elif name == "edges":         # exactly B and B + 1, and their mix
        lens = np.array([B, B + 1, B, 1, B + 1, B - 1, 2 * B, 2 * B + 1,
                         B + 1, B])
        act = np.array([1, 1, 0, 1, 1, 1, 1, 1, 0, 1], bool)
    elif name == "one_long":      # one segment of many chunks
        lens = np.array([23 * B + 7])
        act = np.ones(1, bool)
    elif name == "mixed":         # long, short and inactive segments
        lens = rng.integers(1, 4 * B, 30)
        act = rng.random(30) < 0.7
    elif name == "none":          # a round with no active point
        lens = rng.integers(1, 3 * B, 12)
        act = np.zeros(12, bool)
    else:
        raise ValueError(name)
    return lens, act


def _segments(lens, act):
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    seg = np.repeat(starts, lens).astype(np.int32)
    return torch.as_tensor(seg), torch.as_tensor(np.repeat(act, lens))


CASES = [  # layout, dtype, dim, lam, block_n
    ("singles", np.int32, 2, 3, 64), ("singles", np.float32, 3, 2, 64),
    ("edges", np.int32, 2, 3, 64), ("edges", np.float32, 1, 3, 32),
    ("edges", np.int32, 3, 2, 48), ("one_long", np.int32, 2, 3, 64),
    ("one_long", np.float32, 2, 3, 32), ("mixed", np.int32, 2, 5, 64),
    ("mixed", np.float32, 3, 2, 40), ("mixed", np.int32, 1, 10, 64),
    ("none", np.int32, 2, 3, 64), ("none", np.float32, 3, 2, 32)]


def _inputs(layout, dtype, dim, block_n, seed):
    rng = np.random.default_rng(seed)
    lens, act = _layout(rng, layout, block_n)
    seg, act_t = _segments(lens, act)
    pts, lo, hi = (torch.as_tensor(a)
                   for a in _points(rng, dtype, seg.shape[0], dim))
    return lens, act, pts, lo, hi, seg, act_t


@pytest.mark.parametrize("layout,dtype,dim,lam,block_n", CASES)
def test_round_plain_equals_cpu_route_and_argsort(layout, dtype, dim, lam,
                                                  block_n):
    lens, act, pts, lo, hi, seg, act_t = _inputs(layout, dtype, dim,
                                                 block_n, 3 + dim + lam)
    n = pts.shape[0]
    before = sk.launch_count()
    r = sk.sieve_round(pts, lo, hi, seg, act_t, lam=lam, block_n=block_n)
    assert sk.launch_count() == before      # the CPU takes the plain path
    # the CPU route of segmented_partition, bit for bit
    route = sieve_ops.segmented_partition(
        pts, lo, hi, seg, act_t, lam=lam, block_n=block_n,
        n_chunks=sieve_ops.max_chunks(n, 0, block_n))
    for name, g, w in zip(("dest", "bucket", "lo", "hi"), r[:4], route):
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)
    # dest: a stable argsort by (segment, bucket), inactive points in place
    K = 1 << (lam * dim)
    key = torch.where(act_t, seg.long() * K + r.bucket.long(),
                      torch.arange(n) * K)
    inv = torch.empty(n, dtype=torch.long)
    inv[torch.argsort(key, stable=True)] = torch.arange(n)
    np.testing.assert_array_equal(r.dest.numpy(), inv.numpy())
    want_b, want_lo, want_hi = (np.asarray(w) for w in
                                jporth._split_lambda_levels(
                                    *(jnp.asarray(t.numpy())
                                      for t in (pts, lo, hi)), lam, dim))
    a = act_t.numpy()
    np.testing.assert_array_equal(r.bucket.numpy(), np.where(a, want_b, 0))
    for got, want, own in ((r.lo, want_lo, lo), (r.hi, want_hi, hi)):
        np.testing.assert_array_equal(
            got.numpy(), np.where(a[:, None], want, own.numpy()))
    # the routing and the chunks in use
    n_single = int((act & (lens <= block_n)).sum())
    n_multi = int((-(-lens // block_n) * (act & (lens > block_n))).sum())
    assert r.counts.tolist() == [n_single, n_multi]
    assert r.single.shape == (n_single,) and r.multi.shape == (n_multi,)
    # the scan: prefix[b, m] is hist[b, :m] summed
    assert r.hist.shape == (K, n_multi)
    np.testing.assert_array_equal(r.prefix[:, 1:].numpy(),
                                  np.cumsum(r.hist.numpy(), 1))
    assert (r.prefix[:, 0] == 0).all()


def test_round_plain_chunks_follow_segments():
    """Multi chunks start at every block_n-th point of a long segment;
    single starts are segment starts; both in point order."""
    lens = np.array([70, 20, 200, 64, 65])
    act = np.array([1, 1, 1, 0, 1], bool)
    seg, act_t = _segments(lens, act)
    pts, lo, hi = (torch.as_tensor(a) for a in _points(
        np.random.default_rng(0), np.int32, seg.shape[0], 2))
    r = sieve_ref.sieve_round_plain(pts, lo, hi, seg, act_t, lam=3,
                                    block_n=64)
    assert r.single.tolist() == [70]
    assert r.multi.tolist() == [0, 64, 90, 154, 218, 282, 354, 418]


def _round_state(rng, dtype, n: int):
    """An insert-shaped 2D sieve state over disjoint seed cells (as in
    tests/test_torch_sieve_bbox.py): every other depth-3 cell seeds at
    that cell, the rest at depth 6, with a masked-out tenth."""
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


@pytest.mark.parametrize("dtype,block_n", [(np.int32, 8),
                                           (np.float32, 16)])
def test_sieve_rounds_with_round_plain_match_reference(monkeypatch, dtype,
                                                       block_n):
    """Every round of the port's ``_sieve_rounds`` taken by the mirror
    gives the reference's per-point state after all rounds; at these
    block sizes the rounds take both routes."""
    rng = np.random.default_rng(9)
    phi = 4
    state = _round_state(rng, dtype, 1200)
    want = jporth._sieve_rounds(*map(jnp.asarray, state), phi, 3, 5, 15, 30)
    routes = []

    def mirror(pts, lo, hi, seg_start, act, *, lam, n_chunks):
        r = sieve_ref.sieve_round_plain(pts, lo, hi, seg_start, act,
                                        lam=lam, block_n=block_n)
        routes.append(r.counts.tolist())
        return r.dest, r.bucket, r.lo, r.hi

    monkeypatch.setattr(porth.sieve_ops, "segmented_partition", mirror)
    t = [torch.as_tensor(a) for a in state]
    t[4] = t[4].long()
    got = porth._sieve_rounds(*t, phi, 3, 5, 15, 30)
    for name, g, w in zip(("pts", "ok", "lo", "hi", "key", "depth"), got,
                          want):
        np.testing.assert_array_equal(g.numpy().astype(np.asarray(w).dtype),
                                      np.asarray(w), err_msg=name)
    assert any(m > 0 for _, m in routes) and any(s > 0 for s, _ in routes)
