"""The port on the card: each CUDA kernel against its plain PyTorch
version on the same CUDA tensors (bit-equal; flash attention, whose
softmax sums run in another order, at 2e-5 in f32 and, in bf16, at
1e-2 relative (about one bf16 ulp) and 1e-4 absolute), the engine's
``auto`` routes through the kernels, P-Orth, kd, Zd and spac-z trees
built and updated on the card equal to the same trees on the CPU, a
sync-free ``server.insert``, a smoke LM on the card equal to the same
weights on the CPU, and the attention backward kernels against their
plain version (each gradient within one bf16 ulp, or 1e-5 in f32, plus
1e-5 of its largest) with a smoke model's training gradients on the card
equal to the CPU's; the wkv6 and selective-scan kernels against their
plain versions (outputs and states within 2e-5 of the largest value),
their CPU mirrors (1e-6), calls that carry the state (bit for bit) and a
bit-exact check of the scan's bf16 ``db``,
smoke phi3.5-moe, jamba and rwkv6 models on the card against the
same weights on the CPU; flash attention at the encoder-decoder's cross
shapes (Sq < Skv, queries at offset 0, non-causal) and internvl2's group
of 6, and smoke seamless-m4t (encoder-decoder) and internvl2 (vision
prefix) models on the card against the CPU; the attention backward at
cross attention's form (Sq != Skv, non-causal, queries at offset 0) with
its forward's lse, and a smoke seamless-m4t and internvl2 training step
on the card against the CPU.

Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false (the decision is made in a
fixture, never at import). The file imports neither jax nor ``repro``,
so it runs on a machine with only the port installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import baselines, make_index, porth, spac
from repro_torch.kernels.bbox import kernel as bk
from repro_torch.kernels.flash_attn import backward as fab
from repro_torch.kernels.flash_attn import kernel as fak
from repro_torch.kernels.flash_attn.ref import (attention_bwd_plain,
                                                attention_bwd_tc_plain,
                                                attention_lse_plain,
                                                attention_plain)
from repro_torch.kernels.frontier import kernel as fk
from repro_torch.kernels.frontier import prep
from repro_torch.kernels.knn import kernel as kk
from repro_torch.kernels.knn import ref as knn_ref
from repro_torch.kernels.morton import kernel as mk
from repro_torch.kernels.sieve import kernel as sk
from repro_torch.kernels.sieve import ops as sieve_ops
from repro_torch.kernels.sieve import ref as sieve_ref
from repro_torch.models import encdec, transformer
from repro_torch.serve import ServeEngine
from repro_torch.serving import SpatialServer

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _equal(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dim,k", [(1, 3), (2, 1), (2, 10), (3, 100),
                                   (2, 128)])
def test_knn_flat_kernel_bit_equal(cuda, dim, k):
    rng = np.random.default_rng(dim * 1000 + k)
    q = torch.as_tensor(rng.integers(0, 1 << 20, (700, dim)),
                        dtype=torch.int32, device=cuda)
    p = torch.as_tensor(rng.integers(0, 1 << 20, (9000, dim)),
                        dtype=torch.int32, device=cuda)
    ok = torch.as_tensor(rng.random(9000) > 0.2, device=cuda)
    before = kk.launch_count()
    got = kk.knn_flat(q, p, ok, k=k)
    assert kk.launch_count() == before + 1
    _equal(got, kk.knn_flat_plain(q, p, ok, k=k))


@pytest.mark.parametrize("Q,N,dim,k", [(1, 5, 2, 10), (129, 300, 2, 128),
                                       (4097, 20480, 2, 10),
                                       (300, 40, 3, 17), (77, 0, 2, 4)])
def test_knn_flat_kernel_split_edges(cuda, Q, N, dim, k):
    """Q not a multiple of the query tile, fewer slots than k, k = 128,
    duplicated points whose ties straddle the split ranges, and no slot
    at all: the kernel against the plain version and the split mirror
    at the kernel's own plan."""
    rng = np.random.default_rng(Q + N + k)
    p = rng.integers(0, 64, (N, dim))
    p[::7] = p[:1]                      # ties in every range
    q = torch.as_tensor(rng.integers(0, 64, (Q, dim)), dtype=torch.int32,
                        device=cuda)
    p = torch.as_tensor(p, dtype=torch.int32, device=cuda)
    ok = torch.as_tensor(rng.random(N) > 0.1, device=cuda)
    got = kk.knn_flat(q, p, ok, k=k)
    _equal(got, kk.knn_flat_plain(q, p, ok, k=k))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    _, splits, _ = kk.split_plan(Q, N, k, sms)
    _equal(got, knn_ref.knn_flat_split_plain(q, p, ok, k=k, splits=splits))


def test_knn_flat_wrapper_checks(cuda):
    q = torch.zeros((4, 2), device=cuda)
    p = torch.zeros((8, 2), device=cuda)
    ok = torch.ones(8, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="outside"):
        kk.knn_flat(q, p, ok, k=kk.MAX_K + 1)
    with pytest.raises(ValueError, match="share a device"):
        kk.knn_flat(q, p.cpu(), ok, k=2)
    with pytest.raises(TypeError, match="bool"):
        kk.knn_flat(q, p, ok.int(), k=2)
    with pytest.raises(TypeError, match="float32 or int32"):
        kk.knn_flat(q.double(), p, ok, k=2)


def _leaf_data(R, C, dim, Q, dev, seed=11):
    rng = np.random.default_rng(seed)
    pts = rng.integers(0, 1 << 20, (R, C, dim)).astype(np.int32)
    pts = np.sort(pts.reshape(-1, dim), axis=0).reshape(R, C, dim)
    valid = rng.random((R, C)) > 0.2
    active = rng.random(R) > 0.1
    lo = np.where(valid[..., None], pts, 1 << 30).min(axis=1)
    hi = np.where(valid[..., None], pts, -1).max(axis=1)
    q = rng.integers(0, 1 << 20, (Q, dim))
    return [torch.as_tensor(a, device=dev) for a in
            (pts, valid, active, lo.astype(np.int32), hi.astype(np.int32),
             q.astype(np.int32))]


def _frontier_equal(pr, pts, valid, active, k):
    """One wrapper call (one launch) against the plain walk: (d2, ids)
    bit for bit, and the kernel's reach at least the plain prefix."""
    before = fk.launch_count()
    got = fk.knn_frontier(pr, pts, valid, active, k=k)
    assert fk.launch_count() == before + 1
    want = fk.knn_frontier_plain(pr, pts, valid, active, k=k)
    _equal(got[:2], want[:2])
    assert (got[2] >= want[2]).all()
    assert (got[2] <= pr.order.shape[1]).all()
    return got, want


def _tie_data(R, C, dim, Q, dev, seed, dtype=np.int32):
    """Coordinates from 16 values with a quarter of the points copies of
    others: ties at the k-th distance are common."""
    rng = np.random.default_rng(seed)
    pts = rng.integers(0, 16, (R * C, dim))
    dup = rng.random(R * C) < 0.25
    pts[dup] = pts[rng.integers(0, R * C, int(dup.sum()))]
    pts = np.sort(pts, axis=0).reshape(R, C, dim).astype(dtype)
    valid = rng.random((R, C)) > 0.15
    active = rng.random(R) > 0.1
    return _with_boxes(pts, valid, active, rng.integers(0, 16, (Q, dim)),
                       dev)


def _sparse_data(R, dim, Q, dev, seed):
    """P-Orth-like rows of 64 slots holding one or two points anywhere in
    the row, a fifth of the rows inactive."""
    rng = np.random.default_rng(seed)
    C = 64
    pts = rng.integers(0, 1 << 20, (R * C, dim))
    pts = np.sort(pts, axis=0).reshape(R, C, dim).astype(np.int32)
    valid = np.zeros((R, C), bool)
    rows = np.arange(R)
    valid[rows, rng.integers(0, C, R)] = True
    two = rng.random(R) < 0.5
    valid[rows[two], rng.integers(0, C, R)[two]] = True
    active = rng.random(R) > 0.2
    return _with_boxes(pts, valid, active,
                       rng.integers(0, 1 << 20, (Q, dim)), dev)


def _with_boxes(pts, valid, active, q, dev):
    big = np.iinfo(np.int32).max if pts.dtype == np.int32 else np.inf
    lo = np.where(valid[..., None], pts, big).min(axis=1).astype(pts.dtype)
    hi = np.where(valid[..., None], pts, -big).max(axis=1).astype(pts.dtype)
    return [torch.as_tensor(a, device=dev) for a in
            (pts, valid, active, lo, hi, q.astype(pts.dtype))]


@pytest.mark.parametrize("R,C,dim,Q,k,bq,bp", [
    (37, 16, 2, 33, 8, 8, 64),
    (64, 8, 3, 16, 4, 16, 128),
    (5, 4, 2, 7, 32, 8, 8),
    (3000, 64, 2, 777, 10, 32, 512),
    (3000, 64, 3, 500, 100, 32, 512),
    (3000, 64, 2, 300, 128, 32, 512),
    (3000, 48, 1, 200, 10, 32, 512),
    (3000, 40, 2, 200, 10, 32, 512),
])
def test_knn_frontier_kernel_bit_equal(cuda, R, C, dim, Q, k, bq, bp):
    pts, valid, active, lo, hi, q = _leaf_data(R, C, dim, Q, cuda)
    pr = prep.prepare(pts, valid, active, lo, hi, q, block_q=bq,
                      block_p=bp)
    _frontier_equal(pr, pts, valid, active, k)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("dim,k", [(1, 10), (2, 1), (2, 10), (3, 100),
                                   (2, 128)])
def test_knn_frontier_kernel_ties(cuda, dtype, dim, k):
    pts, valid, active, lo, hi, q = _tie_data(400, 64, dim, 300, cuda,
                                              seed=dim * 31 + k,
                                              dtype=dtype)
    pr = prep.prepare(pts, valid, active, lo, hi, q, block_q=32,
                      block_p=512)
    (d2, _, _), _ = _frontier_equal(pr, pts, valid, active, k)
    assert (d2[:, -1] < 3.4e38).all()    # every row full: ties decide


@pytest.mark.parametrize("dim,k", [(2, 10), (3, 10), (2, 100)])
def test_knn_frontier_kernel_sparse_rows(cuda, dim, k):
    data = _sparse_data(20_000, dim, 256, cuda, seed=dim + k)
    assert int(data[1].sum(1).max()) <= 2
    pr = prep.prepare(*data, block_q=32, block_p=512)
    _frontier_equal(pr, *data[:3], k)


def test_knn_frontier_kernel_long_walk(cuda):
    """Two query blocks spread over the whole tree walk thousands of
    groups, so many CTAs share each block's cursor."""
    pts, valid, active, lo, hi, q = _leaf_data(60_000, 64, 2, 64, cuda,
                                               seed=5)
    pr = prep.prepare(pts, valid, active, lo, hi, q, block_q=32,
                      block_p=512)
    assert pr.order.shape == (2, 7500)
    _, (_, _, steps) = _frontier_equal(pr, pts, valid, active, 10)
    assert int(steps.min()) >= 1000


def test_knn_frontier_kernel_bit_reproducible(cuda):
    data = _tie_data(2000, 64, 2, 900, cuda, seed=3)
    pr = prep.prepare(*data, block_q=32, block_p=512)
    a = fk.knn_frontier(pr, *data[:3], k=10)
    b = fk.knn_frontier(pr, *data[:3], k=10)
    _equal(a[:2], b[:2])


def test_knn_frontier_kernel_k_order(cuda):
    """The walker plan is cached per k; the shared-memory top-k's instance
    serves a smaller k planned after a larger one, and the larger again."""
    data = _tie_data(600, 64, 2, 200, cuda, seed=11)
    pr = prep.prepare(*data, block_q=32, block_p=512)
    for k in (120, 20, 120, 64):
        _frontier_equal(pr, *data[:3], k)


def test_knn_frontier_wrapper_raises_before_launch(cuda):
    pts, valid, active, lo, hi, q = _leaf_data(300, 64, 2, 64, cuda)
    pr = prep.prepare(pts, valid, active, lo, hi, q, block_q=32,
                      block_p=512)
    before = fk.launch_count()
    with pytest.raises(ValueError, match="outside"):
        fk.knn_frontier(pr, pts, valid, active, k=fk.MAX_K + 1)
    strided = pts.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        fk.knn_frontier(pr, strided, valid, active, k=10)
    with pytest.raises(ValueError, match="contiguous"):
        fk.knn_frontier(pr._replace(glb=pr.glb.t().contiguous().t()), pts,
                        valid, active, k=10)
    wide = prep.prepare(pts, valid, active, lo, hi, q, block_q=64,
                        block_p=512)
    with pytest.raises(ValueError, match="block_q"):
        fk.knn_frontier(wide, pts, valid, active, k=10)
    big = prep.prepare(pts, valid, active, lo, hi, q, block_q=32,
                       block_p=1024)
    with pytest.raises(ValueError, match="points_per_group"):
        fk.knn_frontier(big, pts, valid, active, k=10)
    assert fk.launch_count() == before


@pytest.mark.parametrize("n,route", [(2000, "flat:cuda"),
                                     (40_000, "frontier-kernel:cuda")])
def test_engine_auto_route_on_card(cuda, n, route):
    rng = np.random.default_rng(n)
    pts = rng.integers(0, 1 << 20, (n, 2)).astype(np.int32)
    qs = rng.integers(0, 1 << 20, (256, 2)).astype(np.int32)
    idx = make_index("spac-h", pts, phi=32, coord_bits=20)   # the card
    assert idx.device.type == "cuda"
    d2, ids = idx.knn(qs, 10)
    assert idx.engine.route_counts == {route: 1}
    plain = "plain" if route.startswith("flat") else "plain-frontier"
    _equal((d2, ids), idx.knn(qs, 10, impl=plain))
    cpu = make_index("spac-h", pts, phi=32, coord_bits=20, device="cpu")
    d2_cpu, ids_cpu = cpu.knn(qs, 10)
    assert torch.equal(d2.cpu(), d2_cpu) and torch.equal(ids.cpu(), ids_cpu)


def _sieve_state(rng, dtype, n, dim, dev):
    if dtype == torch.float32:
        pts = rng.random((n, dim)).astype(np.float32)
        lo, hi = np.zeros_like(pts), np.ones_like(pts)
    else:
        pts = rng.integers(0, 1 << 20, (n, dim)).astype(np.int32)
        lo = np.zeros_like(pts)
        hi = np.full_like(pts, 1 << 20)
    return [torch.as_tensor(a, device=dev) for a in (pts, lo, hi)]


def _round_equal(got, want):
    """Two ``SieveRound``s, their chunk lists and tables cut to the
    entries in use, field for field."""
    got, want = sieve_ref.in_use(got), sieve_ref.in_use(want)
    for name in got._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    return got


def _segment_layout(rng, name, n, block_n):
    """Segment starts and activity over n points: 'singles' (33-64
    points a segment), 'edges' (block_n and block_n + 1 points), 'long'
    (one segment), 'mixed' (1 to 2 * block_n points, a third inactive),
    'none' (nothing active)."""
    if name == "long":
        lens = np.array([n])
    elif name == "edges":
        lens = np.resize([block_n, block_n + 1], n // block_n)
    else:
        top = {"singles": (33, 65), "mixed": (1, 2 * block_n),
               "none": (1, 4 * block_n)}[name]
        lens = rng.integers(*top, n // top[0] + 1)
    lens = lens[np.cumsum(lens) <= n]
    lens = np.append(lens, n - lens.sum()) if lens.sum() < n else lens
    act = {"none": np.zeros(len(lens), bool),
           "long": np.ones(len(lens), bool),
           "mixed": rng.random(len(lens)) < 0.67}.get(
        name, rng.random(len(lens)) < 0.9)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return (np.repeat(starts, lens).astype(np.int32), np.repeat(act, lens))


@pytest.mark.parametrize("dtype,n,dim,lam,block_n", [
    (torch.int32, 100_000, 2, 3, 1024), (torch.float32, 50_000, 2, 3, 256),
    (torch.int32, 30_000, 3, 2, 1024), (torch.float32, 7, 3, 2, 4096),
    (torch.int32, 5000, 2, 5, 512)])
def test_sieve_kernels_bit_equal(cuda, dtype, n, dim, lam, block_n):
    """The sieve round's kernels against their plain mirror over random
    segments (some inactive), intermediates included, and the
    reference-shaped histogram and partition on the card against the same
    calls on the CPU (the plain route)."""
    rng = np.random.default_rng(n + lam)
    pts, lo, hi = _sieve_state(rng, dtype, n, dim, cuda)
    starts = np.unique(np.concatenate([[0], rng.integers(0, n, 60)]))
    which = np.searchsorted(starts, np.arange(n), side="right") - 1
    seg = torch.as_tensor(starts[which].astype(np.int32), device=cuda)
    act = torch.as_tensor((rng.random(starts.shape[0]) < 0.7)[which],
                          device=cuda)
    before = sk.launch_count()
    got = sk.sieve_round(pts, lo, hi, seg, act, lam=lam, block_n=block_n)
    assert sk.launch_count() == before + 5
    _round_equal(got, sieve_ref.sieve_round_plain(pts, lo, hi, seg, act,
                                                  lam=lam, block_n=block_n))
    for fn in (sieve_ops.sieve_histogram, sieve_ops.sieve_partition):
        got = fn(pts, lo, hi, lam=lam, block_n=block_n)
        want = fn(pts.cpu(), lo.cpu(), hi.cpu(), lam=lam, block_n=block_n)
        _equal([g.cpu() for g in got], want)


@pytest.mark.parametrize("layout,dtype,n,dim,lam,block_n", [
    ("singles", torch.int32, 1_000_000, 2, 3, 1024),
    ("singles", torch.float32, 300_000, 3, 2, 64),
    ("edges", torch.int32, 500_000, 2, 3, 1024),
    ("edges", torch.float32, 200_000, 1, 3, 256),
    ("long", torch.int32, 1_000_000, 2, 3, 1024),
    ("long", torch.float32, 300_000, 2, 5, 512),
    ("mixed", torch.int32, 1_000_000, 2, 5, 1024),
    ("mixed", torch.float32, 400_000, 3, 2, 1024),
    ("mixed", torch.int32, 200_000, 1, 10, 4096),
    ("none", torch.int32, 300_000, 2, 3, 1024)])
def test_sieve_round_layouts_bit_equal(cuda, layout, dtype, n, dim, lam,
                                       block_n):
    """Every routing of the round (all single segments, segments of
    block_n and block_n + 1 points, one segment of many chunks, a mix, no
    active point) against the plain mirror, intermediates included."""
    rng = np.random.default_rng(n + dim)
    pts, lo, hi = _sieve_state(rng, dtype, n, dim, cuda)
    seg, act = (torch.as_tensor(a, device=cuda)
                for a in _segment_layout(rng, layout, n, block_n))
    got = sk.sieve_round(pts, lo, hi, seg, act, lam=lam, block_n=block_n)
    r = _round_equal(got, sieve_ref.sieve_round_plain(
        pts, lo, hi, seg, act, lam=lam, block_n=block_n))
    ns, nm = r.counts.tolist()
    assert {"singles": nm == 0 and ns > 0, "long": ns == 0 and nm > 1,
            "none": ns == nm == 0}.get(layout, ns > 0 and nm > 0)


def test_sieve_round_without_active_points_is_identity(cuda):
    n = 200_000
    rng = np.random.default_rng(1)
    pts, lo, hi = _sieve_state(rng, torch.int32, n, 2, cuda)
    seg = torch.zeros(n, dtype=torch.int32, device=cuda)
    act = torch.zeros(n, dtype=torch.bool, device=cuda)
    r = sieve_ref.in_use(sk.sieve_round(pts, lo, hi, seg, act, lam=3,
                                        block_n=1024))
    assert r.counts.tolist() == [0, 0]
    assert torch.equal(r.dest, torch.arange(n, dtype=torch.int32,
                                            device=cuda))
    assert not r.bucket.any()
    assert torch.equal(r.lo, lo) and torch.equal(r.hi, hi)


@pytest.mark.parametrize("dtype,R,C,dim", [
    (torch.int32, 100_000, 64, 2), (torch.float32, 3000, 16, 3),
    (torch.int32, 9, 70, 1), (torch.float32, 1, 1, 2),
    (torch.int32, 5000, 48, 2), (torch.float32, 50, 1000, 3)])
def test_row_bbox_kernel_bit_equal(cuda, dtype, R, C, dim):
    rng = np.random.default_rng(R + C)
    if dtype == torch.float32:
        pts = rng.standard_normal((R, C, dim)).astype(np.float32)
    else:
        pts = rng.integers(-(1 << 30), 1 << 30, (R, C, dim)).astype(np.int32)
    valid = rng.random((R, C)) > 0.5
    valid[: R // 4] = False
    p = torch.as_tensor(pts, device=cuda)
    v = torch.as_tensor(valid, device=cuda)
    before = bk.launch_count()
    got = bk.row_bbox(p, v)
    assert bk.launch_count() == before + 1
    _equal(got, bk.row_bbox_plain(p, v))


def test_row_bbox_kernel_unaligned_flags(cuda):
    """Flags that start off a 16-byte boundary take the byte loads."""
    rng = np.random.default_rng(11)
    R, C = 3000, 64
    p = torch.as_tensor(rng.integers(-1000, 1000, (R, C, 2)),
                        dtype=torch.int32, device=cuda)
    flat = torch.as_tensor(rng.random(R * C + 1) > 0.7, device=cuda)
    v = flat[1:].view(R, C)
    assert v.data_ptr() % 16 != 0
    _equal(bk.row_bbox(p, v), bk.row_bbox_plain(p, v))


@pytest.mark.parametrize("n", [1, 1023, 1025, 1_000_000])
@pytest.mark.parametrize("dim,bits,coord_bits,hi_bits", [
    (2, 15, 20, 20), (2, 16, 30, 30), (3, 10, 20, 20), (3, 10, 30, 30),
    (2, 15, 20, 24), (3, 10, 20, 27), (2, 16, 10, 31), (1, 20, 20, 20),
    (4, 8, 20, 20)])
def test_morton_kernel_bit_equal(cuda, n, dim, bits, coord_bits, hi_bits):
    """The kernel against its plain version: 2D and 3D (the magic-mask
    spreads), 1D and 4D (the bit loop), coordinates at or above 2^bits
    after the shift, N of one point, around a 1024 block and 10^6."""
    rng = np.random.default_rng(n * 10 + dim)
    p = torch.as_tensor(rng.integers(0, 1 << hi_bits, (n, dim)),
                        dtype=torch.int32, device=cuda)
    before = mk.launch_count()
    got = mk.morton_encode(p, bits=bits, coord_bits=coord_bits)
    assert mk.launch_count() == before + 1
    want = mk.morton_encode_plain(p, bits=bits, coord_bits=coord_bits)
    _equal((got,), (want,))
    _equal((got.cpu(),), (mk.morton_encode_plain(p.cpu(), bits=bits,
                                                 coord_bits=coord_bits),))


def test_morton_kernel_casts_and_unaligned_rows(cuda):
    """Float32, int64 and negative int32 points take the plain version's
    cast; a 2D view that starts off an 8-byte boundary takes the scalar
    loads."""
    rng = np.random.default_rng(3)
    cases = [
        torch.as_tensor(rng.random((5000, 2)) * (1 << 20),
                        dtype=torch.float32, device=cuda),
        torch.as_tensor(rng.integers(0, 1 << 20, (5000, 3)),
                        dtype=torch.int64, device=cuda),
        torch.as_tensor(rng.integers(-(1 << 31), 1 << 31, (5000, 2)),
                        dtype=torch.int32, device=cuda)]
    flat = torch.as_tensor(rng.integers(0, 1 << 20, 2 * 5000 + 1),
                           dtype=torch.int32, device=cuda)
    view = flat[1:].view(5000, 2)
    assert view.data_ptr() % 8 != 0
    cases.append(view)
    for p in cases:
        bits = 10 if p.shape[1] == 3 else 16
        _equal((mk.morton_encode(p, bits=bits, coord_bits=20),),
               (mk.morton_encode_plain(p, bits=bits, coord_bits=20),))
    empty = mk.morton_encode(torch.zeros((0, 2), dtype=torch.int32,
                                         device=cuda), bits=16,
                             coord_bits=20)
    assert empty.shape == (0,) and empty.dtype == torch.int64


@pytest.mark.parametrize("kind,params,fields", [
    ("kd", dict(max_depth=24), baselines.FIELDS),
    ("zd", dict(bits=15, coord_bits=20, lam=3), baselines.FIELDS),
    ("spac-z", dict(coord_bits=20), spac.FIELDS)])
def test_trees_on_card_equal_cpu(cuda, kind, params, fields):
    """kd, zd and spac-z through the facade on the card (zd's and
    spac-z's encodes on the Morton kernel) equal the same trees on the
    CPU, field for field, after the build, a delete and an insert."""
    rng = np.random.default_rng(7)
    pts = rng.integers(0, 1 << 20, (40_000, 2)).astype(np.int32)
    new = rng.integers(0, 1 << 20, (4000, 2)).astype(np.int32)
    morton0 = mk.launch_count()
    gpu = make_index(kind, pts, **params)
    cpu = make_index(kind, pts, device="cpu", **params)
    assert (mk.launch_count() > morton0) == (kind != "kd")
    gpu = gpu.delete(pts[:4000]).insert(new)
    cpu = cpu.delete(pts[:4000]).insert(new)
    got, want = gpu.tree.to_numpy(), cpu.tree.to_numpy()
    for f in fields:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert len(gpu) == 40_000


def test_porth_on_card_equals_cpu(cuda):
    """The P-Orth tree through the facade on the card (sieve and bbox
    kernels) equals the same tree on the CPU (plain versions), field for
    field, after the build and after a delete and an insert."""
    rng = np.random.default_rng(5)
    pts = rng.integers(0, 1 << 20, (40_000, 2)).astype(np.int32)
    new = rng.integers(0, 1 << 20, (4000, 2)).astype(np.int32)
    sieve0, bbox0 = sk.launch_count(), bk.launch_count()
    gpu = make_index("porth", pts)
    cpu = make_index("porth", pts, device="cpu")
    assert sk.launch_count() > sieve0
    gpu = gpu.delete(pts[:4000]).insert(new)
    cpu = cpu.delete(pts[:4000]).insert(new)
    assert bk.launch_count() > bbox0
    got, want = gpu.tree.to_numpy(), cpu.tree.to_numpy()
    for f in porth.FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert len(gpu) == 40_000


# Dynamic kinds only: kd and zd inserts rebuild and then check the
# rebuilt size on the host (the facade's retry rule), so they sync by
# design, as in the reference.
@pytest.mark.parametrize("kind", ["spac-h", "spac-z", "porth"])
def test_server_insert_does_not_sync(cuda, kind):
    rng = np.random.default_rng(3)
    pts = rng.integers(0, 1 << 20, (50_000, 2)).astype(np.int32)
    batch = torch.as_tensor(rng.integers(0, 1 << 20, (4096, 2)),
                            dtype=torch.int32, device=cuda)
    kw = {} if kind == "porth" else dict(coord_bits=20)
    srv = SpatialServer.build(kind, pts, capacity_points=60_000, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            srv.insert(batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    srv.commit()
    assert len(srv.head_index) == 50_000 + 2 * 4096


def test_porth_insert_sieve_rounds_do_not_sync(cuda):
    """A porth insert large enough that its sieve rounds take both the
    multi-chunk and the single-segment routes runs under sync debug mode
    "error" and launches the sieve kernels."""
    rng = np.random.default_rng(4)
    pts = rng.integers(0, 1 << 20, (300_000, 2)).astype(np.int32)
    batch = torch.as_tensor(rng.integers(0, 1 << 20, (100_000, 2)),
                            dtype=torch.int32, device=cuda)
    srv = SpatialServer.build("porth", pts, capacity_points=400_000)
    torch.cuda.synchronize()
    before = sk.launch_count()
    torch.cuda.set_sync_debug_mode("error")
    try:
        srv.insert(batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert sk.launch_count() > before
    srv.commit()
    assert len(srv.head_index) == 400_000


# -------------------------------------------------------------- attention

# kernel against plain version: both compute in f32 and round once to the
# output's type, so bf16 results differ by at most one bf16 ulp (2^-7 of
# the value at most)
ATTN_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
            torch.bfloat16: dict(atol=1e-4, rtol=1e-2)}


def _attn_inputs(cuda, B, Hq, Hkv, Sq, Skv, d, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(s, generator=g, device=cuda).to(dtype)
            for s in ((B, Hq, Sq, d), (B, Hkv, Skv, d), (B, Hkv, Skv, d))]


def _attn_close(got, want, dtype):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dtype])


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,d,causal,window", [
    (2, 4, 4, 100, 100, 64, True, None),     # MHA, ragged tail block
    (1, 8, 2, 64, 64, 128, True, None),      # GQA
    (1, 4, 1, 3, 130, 80, True, None),       # MQA suffix (decode-ish)
    (2, 4, 2, 150, 150, 80, True, 40),       # sliding window
    (1, 2, 2, 33, 70, 64, False, None),      # non-causal, suffix
    (1, 2, 1, 40, 40, 256, True, 16),        # widest head, window
    (1, 2, 2, 20, 50, 30, True, None),       # d not a multiple of 4
    (1, 2, 2, 4, 2, 16, True, None),         # fully masked rows
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attn_kernel_matches_plain(cuda, B, Hq, Hkv, Sq, Skv, d,
                                         causal, window, dtype):
    q, k, v = _attn_inputs(cuda, B, Hq, Hkv, Sq, Skv, d, dtype)
    before = fak.launch_count()
    got = fak.flash_attention(q, k, v, causal=causal, window=window)
    assert fak.launch_count() == before + 1
    _attn_close(got, attention_plain(q, k, v, causal=causal,
                                            window=window), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attn_kernel_ring_positions(cuda, dtype):
    """A ring cache's explicit kv positions (-1 = empty) and a query
    offset, as attention_block gives them."""
    W, off = 48, 100
    q, k, v = _attn_inputs(cuda, 2, 8, 4, 5, W, 64, dtype, seed=1)
    pos = torch.full((W,), -1, dtype=torch.int32, device=cuda)
    live = torch.arange(off - W + 9, off + 5, device=cuda)
    pos[live % W] = live.to(torch.int32)
    for window in (W, 20):
        got = fak.flash_attention(q, k, v, causal=True, window=window,
                                  q_offset=off, k_pos=pos)
        _attn_close(got, attention_plain(
            q, k, v, causal=True, window=window, q_offset=off, k_pos=pos),
            dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attn_kernel_strided_views(cuda, dtype):
    """q from the transpose of a (B, S, H, d) projection and k/v as the
    valid prefix of a longer cache go in without copies."""
    B, H, S, d, cap, n = 2, 4, 7, 64, 96, 57
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn((B, S, H, d), generator=g, device=cuda).to(dtype)
    q = q.transpose(1, 2)
    ck = torch.randn((3, B, H, cap, d), generator=g, device=cuda).to(dtype)
    cv = torch.randn((3, B, H, cap, d), generator=g, device=cuda).to(dtype)
    k, v = ck[1][:, :, :n], cv[1][:, :, :n]
    assert not q.is_contiguous() and not k.is_contiguous()
    got = fak.flash_attention(q, k, v, causal=True, q_offset=n - S)
    assert got.transpose(1, 2).is_contiguous()
    _attn_close(got, attention_plain(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=True),
        dtype)


def test_flash_attn_wrapper_raises(cuda):
    q, k, v = _attn_inputs(cuda, 1, 2, 2, 8, 8, 288, torch.float32)
    with pytest.raises(ValueError, match="head dim 288"):
        fak.flash_attention(q, k, v)
    q, k, v = _attn_inputs(cuda, 1, 2, 2, 8, 8, 64, torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fak.flash_attention(q, k, v)
    q, k, v = _attn_inputs(cuda, 1, 2, 2, 8, 8, 64, torch.float32)
    with pytest.raises(ValueError, match="k_pos must be"):
        fak.flash_attention(q, k, v, k_pos=torch.arange(8, device=cuda))
    with pytest.raises(ValueError, match="k is on"):
        fak.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="window"):
        fak.flash_attention(q, k, v, window=0)


def _ring_pos(cuda, W, off, empty=()):
    """Slot positions of a W-slot ring holding positions ..off-1."""
    pos = torch.full((W,), -1, dtype=torch.int32, device=cuda)
    live = torch.arange(max(0, off - W), off, device=cuda)
    pos[live % W] = live.to(torch.int32)
    pos[list(empty)] = -1
    return pos


def _variant_close(cuda, variant, q, k, v, **kw):
    """The named variant through ``_launch`` against the plain version,
    counted once under its name."""
    before = fak.launch_count(variant)
    got = fak._launch(variant, q, k, v, **kw)
    assert fak.launch_count(variant) == before + 1
    _attn_close(got, attention_plain(q, k, v, **kw), q.dtype)
    return got


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,d,causal,window,q_offset", [
    (2, 4, 4, 100, 100, 32, True, None, None),   # MHA, ragged tail
    (1, 8, 2, 130, 130, 64, True, None, None),   # GQA
    (1, 8, 1, 70, 200, 80, True, None, None),    # MQA suffix
    (2, 4, 2, 150, 150, 80, True, 40, None),     # sliding window
    (1, 4, 4, 33, 70, 128, False, None, None),   # non-causal, suffix
    (1, 4, 2, 90, 50, 64, True, None, None),     # Sq > Skv: masked rows
    (1, 8, 4, 129, 257, 128, True, 100, None),   # window across tiles
    (1, 4, 2, 64, 64, 64, True, None, 0),        # one full tile
    (1, 2, 2, 2, 300, 16, True, None, 7),        # two rows, offset
])
def test_flash_attn_tc_matches_plain(cuda, B, Hq, Hkv, Sq, Skv, d, causal,
                                     window, q_offset):
    q, k, v = _attn_inputs(cuda, B, Hq, Hkv, Sq, Skv, d, torch.bfloat16,
                           seed=d + Sq)
    assert fak.variant_for(q, k, v) == "tc"
    _variant_close(cuda, "tc", q, k, v, causal=causal, window=window,
                   q_offset=q_offset)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,d,causal", [
    (8, 16, 16, 16, 1024, 64, False),   # seamless's cross attention
    (2, 4, 4, 5, 333, 64, False),       # a ragged cross shape
    (2, 48, 8, 1280, 1280, 128, True),  # internvl2's layer: group 6
])
def test_flash_attn_tc_cross_and_group6(cuda, B, Hq, Hkv, Sq, Skv, d,
                                        causal):
    """Cross attention's form (every query sees the whole memory,
    ``q_offset=0``, Sq < Skv) and internvl2's 48 q heads over 8."""
    q, k, v = _attn_inputs(cuda, B, Hq, Hkv, Sq, Skv, d, torch.bfloat16,
                           seed=Skv + Sq)
    assert fak.variant_for(q, k, v) == "tc"
    _variant_close(cuda, "tc", q, k, v, causal=causal, q_offset=0)


@pytest.mark.parametrize("B,Hq,Hkv,Skv,d,causal", [
    (8, 16, 16, 1024, 64, False),   # seamless's cross attention, group 1
    (2, 4, 4, 333, 64, False),
    (4, 48, 8, 1311, 128, True),    # internvl2's decode step, group 6
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attn_decode_cross_and_group6(cuda, B, Hq, Hkv, Skv, d,
                                            causal, dtype):
    """decode over the full span of a non-causal memory (the cross
    cache's contiguous ``mem_k[l]``), and at internvl2's group of 6."""
    q, k, v = _attn_inputs(cuda, B, Hq, Hkv, 1, Skv, d, dtype, seed=Skv)
    assert fak.variant_for(q, k, v) == "decode"
    _variant_close(cuda, "decode", q, k, v, causal=causal,
                   q_offset=0 if not causal else None)


@pytest.mark.parametrize("d", [64, 80])
def test_flash_attn_tc_ring_positions(cuda, d):
    """A ring's explicit positions (empty slots, out of order) in a
    query block of a ring prefill."""
    W, off = 96, 150
    q, k, v = _attn_inputs(cuda, 2, 8, 4, 20, W, d, torch.bfloat16, seed=4)
    pos = _ring_pos(cuda, W, off, empty=(5, 70))
    for window in (W, 30):
        _variant_close(cuda, "tc", q, k, v, causal=True, window=window,
                       q_offset=off - 20, k_pos=pos)


def test_flash_attn_tc_strided_views(cuda):
    """q from the transpose of a (B, S, H, d) projection, k/v the valid
    prefix of a longer cache (the LM path's views) go to tc as they
    are; a sequence stride off 16 bytes goes to simt."""
    B, H, S, d, cap, n = 2, 4, 70, 64, 200, 133
    g = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randn((B, S, H, d), generator=g, device=cuda).to(
        torch.bfloat16).transpose(1, 2)
    ck = torch.randn((3, B, H, cap, d), generator=g, device=cuda).to(
        torch.bfloat16)
    cv = torch.randn_like(ck)
    k, v = ck[1][:, :, :n], cv[1][:, :, :n]
    assert fak.variant_for(q, k, v) == "tc"
    got = _variant_close(cuda, "tc", q, k, v, causal=True, q_offset=n - S)
    assert got.transpose(1, 2).is_contiguous()
    wide = torch.randn((B, H, cap, d + 4), generator=g, device=cuda).to(
        torch.bfloat16)
    k_odd = wide[:, :, :n, :d]
    assert fak.variant_for(q, k_odd, k_odd) == "simt"
    with pytest.raises(ValueError, match="tc variant does not take"):
        fak._launch("tc", q, k_odd, k_odd)
    before = fak.launch_count("simt")
    got = fak.flash_attention(q, k_odd, k_odd, causal=True)
    assert fak.launch_count("simt") == before + 1
    _attn_close(got, attention_plain(q, k_odd, k_odd, causal=True),
                torch.bfloat16)


@pytest.mark.parametrize("Skv", [1, 7, 255, 256, 257, 2175])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attn_decode_matches_plain(cuda, Skv, dtype):
    q, k, v = _attn_inputs(cuda, 8, 16, 16, 1, Skv, 64, dtype, seed=Skv)
    assert fak.variant_for(q, k, v) == "decode"
    _variant_close(cuda, "decode", q, k, v, causal=True)


@pytest.mark.parametrize("B,Hq,Hkv,Skv,d,window", [
    (1, 32, 4, 2175, 128, None),   # yi's grouped heads
    (2, 32, 8, 1000, 80, 300),     # danube's width, a window
    (2, 4, 2, 513, 256, None),     # the widest head
    (2, 4, 1, 300, 30, None),      # a width off 16 bytes (scalar loads)
    (1, 64, 1, 200, 64, None),     # many q heads a kv head
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attn_decode_widths_and_groups(cuda, B, Hq, Hkv, Skv, d,
                                             window, dtype):
    q, k, v = _attn_inputs(cuda, B, Hq, Hkv, 1, Skv, d, dtype, seed=d)
    _variant_close(cuda, "decode", q, k, v, causal=True, window=window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attn_decode_ring_and_prefix_view(cuda, dtype):
    """A ring cache (empty slots, a chunk of them) and a cache's valid
    prefix as a strided view."""
    W, off = 600, 900
    q, k, v = _attn_inputs(cuda, 2, 8, 2, 1, W, 64, dtype, seed=8)
    pos = _ring_pos(cuda, W, off, empty=range(100, 140))
    for window in (W, 200):
        _variant_close(cuda, "decode", q, k, v, causal=True, window=window,
                       q_offset=off, k_pos=pos)
    ck = torch.randn((2, 2, 2, 800, 64), device=cuda).to(dtype)
    cv = torch.randn_like(ck)
    _variant_close(cuda, "decode", q, ck[1][:, :, :517], cv[1][:, :, :517],
                   causal=True)
    _variant_close(cuda, "decode", q, ck[1][:, :, :517], cv[1][:, :, :517],
                   causal=True, q_offset=-1)   # sees no slot: 0


def test_flash_attn_decode_bit_reproducible(cuda):
    q, k, v = _attn_inputs(cuda, 8, 16, 16, 1, 2175, 64, torch.bfloat16,
                           seed=9)
    a = fak._launch("decode", q, k, v, causal=True)
    b = fak._launch("decode", q, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attn_simt_matches_plain(cuda, dtype):
    """simt takes every input, those of tc and decode too."""
    for Sq in (100, 1):
        q, k, v = _attn_inputs(cuda, 2, 8, 2, Sq, 150, 64, dtype, seed=10)
        _variant_close(cuda, "simt", q, k, v, causal=True, window=60)


def test_flash_attn_launch_refuses_a_variant_that_does_not_fit(cuda):
    q, k, v = _attn_inputs(cuda, 1, 2, 2, 8, 8, 64, torch.float32)
    with pytest.raises(ValueError, match="tc variant does not take"):
        fak._launch("tc", q, k, v)
    with pytest.raises(ValueError, match="decode variant does not take"):
        fak._launch("decode", q, k, v)
    with pytest.raises(ValueError, match="unknown variant"):
        fak._launch("wgmma", q, k, v)


# backward kernels against their plain version, each of dq, dk, dv:
# |got - want| <= rtol |want| + atol_rel (the largest |want| of the three)
# (one bf16 ulp in bf16; f32 sums in another order)
BWD_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-5)}


def _bwd_close(got, want, dtype):
    torch.cuda.synchronize()
    rtol, arel = BWD_TOL[dtype]
    top = max(float(w.float().abs().max()) for w in want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dtype and g.shape == w.shape
        g, w = g.float(), w.float()
        bar = rtol * w.abs() + arel * top
        assert bool(((g - w).abs() <= bar).all()), \
            float(((g - w).abs() / bar).max())


# tc's kernels against their CPU mirror (attention_bwd_tc_plain, the same
# arithmetic): |got - want| <= one bf16 ulp of max(|got|, |want|) +
# TC_MIRROR_TOL (the largest |want| of the three). Both round f32
# gradients once to bf16, so values near a rounding edge land one ulp
# apart; before that rounding the f32 sums differ by wgmma's internal
# summation order and 2^x on the SFU (2 f32 ulp of a term), which the
# atol bounds where cancellation leaves a gradient small: 5e-6 is ~42
# f32 ulps of the largest gradient (chip_smoke's backward row reads the
# atol needed, `mirror.atol_needed_of_max`)
TC_MIRROR_TOL = 5e-6


def _mirror_close(got, want):
    """dq, dk, dv of tc within one bf16 ulp of its mirror's, plus
    ``TC_MIRROR_TOL`` of the largest magnitude."""
    torch.cuda.synchronize()
    top = max(float(w.float().abs().max()) for w in want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.bfloat16 and g.shape == w.shape
        g, w = g.float(), w.float()
        big = torch.maximum(g.abs(), w.abs()).clamp_min(1e-30)
        ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
        bar = ulp + TC_MIRROR_TOL * top
        assert bool(((g - w).abs() <= bar).all()), \
            float(((g - w).abs() / bar).max())


@pytest.mark.parametrize("B,Hq,Hkv,S,d,causal,window", [
    (2, 4, 4, 100, 64, True, None),      # MHA, ragged tail block
    (1, 8, 2, 64, 128, True, None),      # GQA, the widest head
    (2, 4, 2, 150, 80, True, 40),        # sliding window, d = 80
    (1, 2, 2, 70, 64, False, None),      # non-causal
    (1, 4, 1, 33, 32, False, 8),         # MQA, non-causal window
    (1, 2, 2, 1, 16, True, None),        # one row
    (1, 4, 2, 200, 48, True, None),      # d = 48, ragged past 128 rows
    (2, 4, 4, 77, 96, False, None),      # d = 96, non-causal, ragged
    (1, 6, 3, 260, 112, True, 50),       # d = 112, window, ragged
    (1, 4, 4, 130, 16, True, 64),        # d = 16, window, ragged
    (1, 8, 4, 257, 128, False, 100),     # d = 128, non-causal window
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attn_bwd_matches_plain(cuda, B, Hq, Hkv, S, d, causal,
                                      window, dtype):
    """The training form: the forward's lse against the plain one, and
    the three backward kernels against ``attention_bwd_plain``; in bf16
    (tc, every tc width) also against tc's mirror
    ``attention_bwd_tc_plain`` (``_mirror_close``)."""
    q, k, v = _attn_inputs(cuda, B, Hq, Hkv, S, S, d, dtype, seed=S + d)
    do = torch.randn(q.shape, device=cuda).to(dtype)
    kw = dict(causal=causal, window=window)
    o, lse = fak.flash_attention_lse(q, k, v, **kw)
    want_o, want_lse = attention_lse_plain(q, k, v, **kw)
    _attn_close(o, want_o, dtype)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    want = attention_bwd_plain(q, k, v, o, lse, do, **kw)
    variant = "tc" if dtype == torch.bfloat16 else "simt"
    assert fab.variant_for(q, k, v, o, do) == variant
    before = (fab.launch_count(), fab.launch_count(variant))
    got = fab.attention_bwd(q, k, v, o, lse, do, **kw)
    assert (fab.launch_count(), fab.launch_count(variant)) == \
        (before[0] + 3, before[1] + 1)
    _bwd_close(got, want, dtype)
    if variant == "tc":
        _mirror_close(got, attention_bwd_tc_plain(q, k, v, o, lse, do,
                                                  **kw))
        _bwd_close(fab.attention_bwd(q, k, v, o, lse, do, variant="simt",
                                     **kw), want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attn_lse_leaves_outputs_unchanged(cuda, dtype):
    """Writing the lse changes nothing else: tc (bf16) and simt give the
    serving call's output bit for bit."""
    q, k, v = _attn_inputs(cuda, 2, 8, 4, 200, 200, 64, dtype, seed=9)
    for window in (None, 50):
        want = fak.flash_attention(q, k, v, causal=True, window=window)
        got, _ = fak.flash_attention_lse(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_flash_attn_bwd_bit_reproducible(cuda):
    q, k, v = _attn_inputs(cuda, 2, 8, 2, 300, 300, 64, torch.bfloat16,
                           seed=4)
    do = torch.randn(q.shape, device=cuda).to(torch.bfloat16)
    o, lse = fak.flash_attention_lse(q, k, v, causal=True)
    a = fab.attention_bwd(q, k, v, o, lse, do, causal=True)
    b = fab.attention_bwd(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_flash_attn_bwd_tc_strided_and_unaligned(cuda):
    """The models' (B, S, H, d) views go to tc as they are (a broadcast
    dO is copied for its tensor map); a view with rows off 16 bytes goes
    to simt, and all agree with the plain version."""
    B, S, H, d = 2, 96, 4, 64
    base = torch.randn((B, S, H, d + 8), device=cuda).to(torch.bfloat16)
    q = base[..., :d].transpose(1, 2)                 # row stride d + 8
    odd = torch.randn((B, S, H, d + 1), device=cuda).to(torch.bfloat16)
    k = odd[..., 1:].transpose(1, 2)                  # base off 16 bytes
    v = torch.randn((B, S, H, d), device=cuda).to(torch.bfloat16)
    v = v.transpose(1, 2)
    do = torch.randn((B, S, H, d), device=cuda).to(torch.bfloat16)
    do = do.transpose(1, 2)
    for kk in (v, k):
        o, lse = fak.flash_attention_lse(q, kk, v, causal=True)
        want = attention_bwd_plain(q, kk, v, o, lse, do, causal=True)
        assert fab.variant_for(q, kk, v, o, do) == \
            ("tc" if kk is v else "simt")
        _bwd_close(fab.attention_bwd(q, kk, v, o, lse, do, causal=True),
                   want, torch.bfloat16)
    wide = torch.randn((1, 1, 1, d), device=cuda).to(torch.bfloat16)
    wide = wide.expand(B, H, S, d)                    # strides (0, 0, 0, 1)
    o, lse = fak.flash_attention_lse(q, v, v, causal=True)
    assert fab.variant_for(q, v, v, o, wide) == "tc"
    _bwd_close(fab.attention_bwd(q, v, v, o, lse, wide, causal=True),
               attention_bwd_plain(q, v, v, o, lse, wide, causal=True),
               torch.bfloat16)


def test_flash_attn_bwd_wrapper_raises(cuda):
    q, k, v = _attn_inputs(cuda, 1, 2, 2, 8, 8, 24, torch.float32)
    with pytest.raises(ValueError, match="training form"):
        fab.flash_attention_train(q, k, v)
    q, k, v = _attn_inputs(cuda, 1, 2, 2, 8, 16, 32, torch.float32)
    with pytest.raises(ValueError, match="training form"):
        fab.flash_attention_train(q, k, v)
    q, k, v = _attn_inputs(cuda, 1, 2, 2, 8, 8, 32, torch.float16)
    with pytest.raises(TypeError):
        fab.flash_attention_train(q, k, v)
    q, k, v = _attn_inputs(cuda, 1, 2, 2, 8, 8, 32, torch.float32)
    o, lse = fak.flash_attention_lse(q, k, v)
    with pytest.raises(ValueError, match="variant"):
        fab.attention_bwd(q, k, v, o, lse, q, variant="tc")


# cross attention's backward (B, Hq, Hkv, Sq, Skv, d): seamless's decoder
# over its memory (Sq = 2 Skv), few queries over a long memory, ragged
# lengths off the 64-row tile at the widest head
CROSS_BWD_CASES = [(4, 16, 16, 2048, 1024, 64), (2, 4, 4, 16, 1024, 64),
                   (1, 4, 2, 1000, 333, 128)]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,d", CROSS_BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attn_bwd_cross_matches_plain(cuda, B, Hq, Hkv, Sq, Skv, d,
                                            dtype):
    """Cross attention's training form (non-causal, no window, queries at
    offset 0, Sq != Skv): the forward's o and lse against the plain ones,
    the backward kernels (simt in f32; tc and simt in bf16, tc also
    against its mirror) against ``attention_bwd_plain``, three launches a
    call; dk and dv have k's and v's length."""
    q, k, v = _attn_inputs(cuda, B, Hq, Hkv, Sq, Skv, d, dtype,
                           seed=Sq + Skv)
    do = torch.randn(q.shape, device=cuda).to(dtype)
    kw = dict(causal=False, window=None)
    o, lse = fak.flash_attention_lse(q, k, v, **kw)
    want_o, want_lse = attention_lse_plain(q, k, v, q_offset=0, **kw)
    _attn_close(o, want_o, dtype)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    want = attention_bwd_plain(q, k, v, o, lse, do, q_offset=0, **kw)
    variant = "tc" if dtype == torch.bfloat16 else "simt"
    assert fab.variant_for(q, k, v, o, do) == variant
    before = (fab.launch_count(), fab.launch_count(variant))
    got = fab.attention_bwd(q, k, v, o, lse, do, **kw)
    assert (fab.launch_count(), fab.launch_count(variant)) == \
        (before[0] + 3, before[1] + 1)
    assert tuple(got[1].shape) == tuple(got[2].shape) == (B, Hkv, Skv, d)
    _bwd_close(got, want, dtype)
    if variant == "tc":
        _mirror_close(got, attention_bwd_tc_plain(q, k, v, o, lse, do,
                                                  **kw))
        _bwd_close(fab.attention_bwd(q, k, v, o, lse, do, variant="simt",
                                     **kw), want, dtype)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,d", [
    (4, 16, 16, 2048, 1024, 64), (2, 4, 2, 300, 70, 128),
    (1, 2, 2, 129, 1, 64)])
def test_flash_attn_lse_tc_cross_matches_plain(cuda, B, Hq, Hkv, Sq, Skv, d):
    """The tc forward with its lse at Sq > Skv (query tiles past the last
    kv slot, every query at offset 0 seeing every slot) against
    ``attention_lse_plain``; ``flash_attention`` at ``q_offset=0`` gives
    the same output bit for bit."""
    q, k, v = _attn_inputs(cuda, B, Hq, Hkv, Sq, Skv, d, torch.bfloat16,
                           seed=Sq * 3 + Skv)
    assert fak.variant_for(q, k, v) == "tc"
    before = fak.launch_count("tc")
    o, lse = fak.flash_attention_lse(q, k, v, causal=False)
    assert fak.launch_count("tc") == before + 1
    want_o, want_lse = attention_lse_plain(q, k, v, causal=False,
                                           q_offset=0)
    _attn_close(o, want_o, torch.bfloat16)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    assert torch.equal(o, fak.flash_attention(q, k, v, causal=False,
                                              q_offset=0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attn_bwd_cross_bit_reproducible(cuda, dtype):
    q, k, v = _attn_inputs(cuda, 2, 8, 8, 1000, 333, 64, dtype, seed=5)
    do = torch.randn(q.shape, device=cuda).to(dtype)
    o, lse = fak.flash_attention_lse(q, k, v, causal=False)
    a = fab.attention_bwd(q, k, v, o, lse, do, causal=False)
    b = fab.attention_bwd(q, k, v, o, lse, do, causal=False)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "internvl2-26b"])
def test_smoke_multimodal_training_step_on_card_equals_cpu(cuda, arch):
    """One full ``make_train_step`` step of the smoke seamless-m4t
    (encoder-decoder, cross attention at Sq = 2 Skv) and internvl2 (patch
    prefix) at f32 on the card (simt forward, backward kernels, remat
    "dots") and on the CPU from the same weights and batch: the gradients
    to 1e-4 of each leaf's largest, the loss to 1e-5 and the clipped
    gradient norm to 1e-4; the step's launches exact; every updated
    weight within 2 lr of the CPU's (the first AdamW step is about lr
    times the gradient's sign)."""
    from repro_torch.launch.train import make_batches
    from repro_torch.optim.adamw import OptCfg
    from repro_torch.train import step as tstep
    cfg = configs.smoke(arch).with_(act_dtype="float32")
    tcfg = tstep.TrainCfg(opt=OptCfg(lr=1e-3, warmup_steps=1,
                                     total_steps=10))
    cpu, cpu_opt = tstep.init_train_state(3, cfg, tcfg, device="cpu")
    gpu, gpu_opt = tstep.init_train_state(4, cfg, tcfg, device=cuda)
    with torch.no_grad():
        for a, b in zip(gpu.parameters(), cpu.parameters()):
            a.copy_(b)
    _, batch = next(make_batches(cfg, 7, 1, 2, 48, device="cpu"))
    gbatch = {k: t.to(cuda) for k, t in batch.items()}
    loss_g, grads_g = tstep._value_and_grad(gpu, gbatch)
    loss_c, grads_c = tstep._value_and_grad(cpu, batch)
    assert abs(float(loss_g) - float(loss_c)) <= 1e-5 * abs(float(loss_c))
    for name, b in grads_c.items():
        assert float((grads_g[name].cpu() - b).abs().max()) <= \
            1e-4 * float(b.abs().max()), name
    calls = cfg.n_layers + (cfg.encoder_layers + cfg.n_layers
                            if cfg.kind == "encdec" else 0)
    before = (fak.launch_count("simt"), fab.launch_count())
    _, _, met_g = tstep.make_train_step(cfg, tcfg)(gpu, gpu_opt, gbatch)
    assert (fak.launch_count("simt") - before[0],
            fab.launch_count() - before[1]) == (2 * calls, 3 * calls)
    _, _, met_c = tstep.make_train_step(cfg, tcfg)(cpu, cpu_opt, batch)
    assert abs(float(met_g["loss"]) - float(met_c["loss"])) <= \
        1e-5 * abs(float(met_c["loss"]))
    assert abs(float(met_g["grad_norm"]) - float(met_c["grad_norm"])) <= \
        1e-4 * float(met_c["grad_norm"])
    for a, b in zip(gpu.parameters(), cpu.parameters()):
        assert float((a.detach().cpu() - b.detach()).abs().max()) <= \
            2 * tcfg.opt.lr


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "h2o-danube-1.8b",
                                  "rwkv6-3b", "jamba-1.5-large-398b"])
def test_smoke_training_on_card_equals_cpu(cuda, arch):
    """The same smoke weights and batch, f32, on the card (simt forward,
    backward kernels, the recurrence kernels forward and backward, remat
    "dots") and on the CPU (plain versions; MoE capacity 4.0, so no token
    drops): the loss to 1e-5 and each gradient leaf to 1e-4 of its
    largest."""
    import dataclasses

    from repro_torch.kernels.selective_scan import kernel as ssk
    from repro_torch.kernels.wkv import kernel as wk
    cfg = configs.smoke(arch).with_(act_dtype="float32")
    if cfg.moe is not None:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=4.0))
    cpu = transformer.DecoderLM(cfg, device="cpu", train=True,
                                generator=torch.Generator().manual_seed(3))
    gpu = transformer.DecoderLM(cfg, train=True, generator=torch.Generator(
        device=cuda).manual_seed(4))
    with torch.no_grad():
        for a, b in zip(gpu.parameters(), cpu.parameters()):
            a.copy_(b)
    rng = np.random.default_rng(6)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 48)))
    labels = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 48)))
    n = {kind: cfg.n_groups * cfg.pattern.count(kind) for kind in "amr"}
    before = (fab.launch_count(), wk.launch_count("bwd"),
              ssk.launch_count("bwd"))
    loss_g = transformer.loss_fn(gpu, toks.to(cuda), labels.to(cuda))
    grads_g = torch.autograd.grad(loss_g, list(gpu.parameters()))
    assert (fab.launch_count() - before[0], wk.launch_count("bwd") - before[1],
            ssk.launch_count("bwd") - before[2]) == (3 * n["a"], n["r"],
                                                     n["m"])
    loss_c = transformer.loss_fn(cpu, toks, labels)
    grads_c = torch.autograd.grad(loss_c, list(cpu.parameters()))
    assert abs(float(loss_g) - float(loss_c)) <= 1e-5 * abs(float(loss_c))
    for a, b in zip(grads_g, grads_c):
        assert float((a.cpu() - b).abs().max()) <= \
            1e-4 * float(b.abs().max())


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "h2o-danube-1.8b"])
def test_smoke_lm_on_card_equals_cpu(cuda, arch):
    """A smoke model built on the card (flash-attention kernel) and the
    same weights on the CPU (plain version), f32: teacher-forced logits
    agree to 1e-4 of their scale and greedy tokens are equal."""
    cfg = configs.smoke(arch).with_(act_dtype="float32")
    cpu = transformer.DecoderLM(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(3))
    gpu = transformer.DecoderLM(cfg, generator=torch.Generator(
        device=cuda).manual_seed(4))
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (2, 40))
    before = fak.launch_count()
    got = transformer.forward(gpu, torch.as_tensor(toks, device=cuda))
    assert fak.launch_count() == before + cfg.n_layers
    want = transformer.forward(cpu, torch.as_tensor(toks))
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) / scale < 1e-4
    P, n = 30, 10
    out_gpu = ServeEngine(cfg, gpu, 48).generate(
        torch.as_tensor(toks[:, :P], device=cuda), n)
    out_cpu = ServeEngine(cfg, cpu, 48).generate(torch.as_tensor(
        toks[:, :P]), n)
    assert torch.equal(out_gpu.cpu(), out_cpu)


@pytest.mark.parametrize("kind", ["spac-h", "spac-z", "porth"])
def test_distributed_index_on_card_equals_cpu(cuda, kind):
    """8 lanes of the card (``simulate_mesh``) against 8 lanes of the
    CPU: the same splitters, shard trees, sizes and answers, through the
    kernels (the flat kernel on these small shards, the frontier kernel
    when asked)."""
    from repro_torch.configs import platform
    rng = np.random.default_rng(22)
    pts = rng.integers(0, 1 << 20, (6000, 2)).astype(np.int32)
    newp = rng.integers(0, 1 << 20, (700, 2)).astype(np.int32)
    qs = rng.integers(0, 1 << 20, (64, 2)).astype(np.int32)
    lo = rng.integers(0, 1 << 19, (32, 2)).astype(np.int32)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        mesh = platform.simulate_mesh(8, device=dev)
        idx = make_index(kind, pts, mesh=mesh, phi=8, coord_bits=20) \
            if kind != "porth" else make_index(kind, pts, mesh=mesh, phi=8)
        idx = idx.insert(newp).delete(pts[:500])
        before = kk.launch_count() + fk.launch_count()
        answers = [*idx.knn(qs, 10), *idx.knn(qs, 10,
                                              impl="cuda-frontier"),
                   idx.range_count(lo, lo + (1 << 18))]
        if dev.type == "cuda":
            assert kk.launch_count() + fk.launch_count() >= before + 16
        out[dev.type] = (idx, [a.cpu() for a in answers])
    (gpu, got), (cpu, want) = out["cuda"], out["cpu"]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(gpu.index.splitters.cpu(), cpu.index.splitters)
    for tg, tc in zip(gpu.tree, cpu.tree):
        a, b = tg.to_numpy(), tc.to_numpy()
        for f in a:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)


@pytest.mark.parametrize("kind", ["spac-h", "porth"])
def test_distributed_server_insert_is_sync_free(cuda, kind):
    from repro_torch.configs import platform
    rng = np.random.default_rng(7)
    pts = torch.as_tensor(rng.integers(0, 1 << 20, (20000, 2)),
                          dtype=torch.int32, device=cuda)
    batch = torch.as_tensor(rng.integers(0, 1 << 20, (2000, 2)),
                            dtype=torch.int32, device=cuda)
    srv = SpatialServer.build(kind, pts, mesh=platform.simulate_mesh(
        8, device=cuda), phi=32, window=4)
    srv.insert(batch)
    srv.commit()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            srv.insert(batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    srv.commit()
    assert len(srv.head_index) == 20000 + 4 * 2000
    assert srv.stats["recoveries"] == 0


# the recurrence kernels (wkv6, selective scan) against their plain
# versions: both run the same f32 arithmetic per token, with bf16 inputs
# rounded identically (the selective scan's db in the activation type),
# and differ only in the order of the f32 sums (over the head's keys or
# the d_state states) and in the exponential's last bits, so each output
# and state lies within 2e-5 of the largest |value| of its kind
REC_REL = 2e-5


def _rec_close(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float32
        bar = REC_REL * float(w.abs().max())
        assert float((g - w).abs().max()) <= bar


def _wkv_inputs(cuda, B, S, H, hd, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda)

    r, k, v = (rnd(B, S, H, hd).to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(rnd(B, S, H, hd) - 1))
    return r, k, v, w, rnd(H, hd) * 0.1, rnd(B, H, hd, hd)


@pytest.mark.parametrize("S", [1, 5, 300])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_kernel_matches_plain(cuda, S, hd, dtype):
    from repro_torch.kernels.wkv import kernel as wk
    from repro_torch.kernels.wkv.ref import wkv6_plain
    args = _wkv_inputs(cuda, 2, S, 3, hd, dtype, S + hd)
    before = wk.launch_count()
    got = wk.wkv6(*args)
    assert wk.launch_count() == before + 1
    _rec_close(got, wkv6_plain(*args))
    # in place: the state buffer given as out_state
    state = args[-1].clone()
    y, s = wk.wkv6(*args[:-1], state, out_state=state)
    assert s is state
    _rec_close((y, state), got)


def _scan_inputs(cuda, B, S, di, ds, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda)

    dt = torch.nn.functional.softplus(rnd(B, S, di) - 2).to(dtype)
    A = -torch.arange(1, ds + 1, device=cuda).float().expand(di, ds) * (
        1 + 0.5 * torch.rand((di, ds), generator=g, device=cuda))
    return (dt, rnd(B, S, di).to(dtype), A.contiguous(),
            rnd(B, S, ds).to(dtype), rnd(B, S, ds).to(dtype), rnd(di),
            rnd(B, di, ds))


@pytest.mark.parametrize("S", [1, 5, 300])
@pytest.mark.parametrize("di,ds", [(256, 4), (300, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_kernel_matches_plain(cuda, S, di, ds, dtype):
    from repro_torch.kernels.selective_scan import kernel as ssk
    from repro_torch.kernels.selective_scan.ref import selective_scan_plain
    args = _scan_inputs(cuda, 2, S, di, ds, dtype, S + ds)
    before = ssk.launch_count()
    got = ssk.selective_scan(*args)
    assert ssk.launch_count() == before + 1
    _rec_close(got, selective_scan_plain(*args))
    state = args[-1].clone()
    y, h = ssk.selective_scan(*args[:-1], state, out_state=state)
    assert h is state
    _rec_close((y, state), got)


def _split_calls(fn, args, seq, cut):
    """``fn`` on tokens [0, cut) and then [cut, S) carrying the state (the
    last argument), against one call: outputs and state bit for bit."""
    y, st = fn(*args)
    first = [a[:, :cut] if i in seq else a for i, a in enumerate(args)]
    y1, s1 = fn(*first)
    rest = [a[:, cut:] if i in seq else a for i, a in enumerate(args)]
    y2, s2 = fn(*rest[:-1], s1)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(s2, st)


@pytest.mark.parametrize("S,cut", [(29, 13), (29, 28)])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_kernel_carries_state_across_calls(cuda, S, cut, hd, dtype):
    """Split inside the kernel's first 16-token stage, and a last call of
    one token (the decode kernel, whose sums run in the staged kernel's
    order)."""
    from repro_torch.kernels.wkv import kernel as wk
    _split_calls(wk.wkv6, _wkv_inputs(cuda, 2, S, 3, hd, dtype, hd + cut),
                 (0, 1, 2, 3), cut)


@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_kernel_is_its_split_mirror(cuda, hd, dtype):
    """The kernel against ``ref.wkv6_split_plain`` (its decomposition and
    order of sums, FMAs in f64 rounded once) on CPU copies: the same bits
    but for a rare double rounding of an emulated FMA (1e-6 of the
    largest value)."""
    from repro_torch.kernels.wkv import kernel as wk
    from repro_torch.kernels.wkv.ref import wkv6_split_plain
    args = _wkv_inputs(cuda, 2, 37, 3, hd, dtype, 5)
    got = wk.wkv6(*args)
    want = wkv6_split_plain(*(a.cpu() for a in args))
    for g, w in zip(got, want):
        assert float((g.cpu() - w).abs().max()) <= 1e-6 * float(
            w.abs().max())


@pytest.mark.parametrize("w_lo", [1e-6, 1e-2])
def test_wkv6_kernel_at_extreme_decays(cuda, w_lo):
    """Decays near 0 and near 1 (each key drawn from both), 300 tokens."""
    from repro_torch.kernels.wkv import kernel as wk
    from repro_torch.kernels.wkv.ref import wkv6_plain
    r, k, v, w, u, s0 = _wkv_inputs(cuda, 2, 300, 3, 64, torch.bfloat16, 7)
    pick = torch.rand(w.shape, generator=torch.Generator(
        device=cuda).manual_seed(8), device=cuda) < 0.5
    w = torch.where(pick, torch.full_like(w, w_lo),
                    torch.full_like(w, 1 - w_lo))
    args = (r, k, v, w, u, s0)
    _rec_close(wk.wkv6(*args), wkv6_plain(*args))


@pytest.mark.parametrize("B,H,S", [(1, 1, 33), (3, 1, 17)])
@pytest.mark.parametrize("hd", [32, 64])
def test_wkv6_kernel_at_few_heads(cuda, B, H, S, hd):
    """B H heads that fill few CTAs, S not a multiple of the stage."""
    from repro_torch.kernels.wkv import kernel as wk
    from repro_torch.kernels.wkv.ref import wkv6_plain
    args = _wkv_inputs(cuda, B, S, H, hd, torch.bfloat16, B + H + S)
    _rec_close(wk.wkv6(*args), wkv6_plain(*args))


@pytest.mark.parametrize("S,cut", [(30, 11), (30, 29)])
@pytest.mark.parametrize("di,ds", [(256, 16), (131, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_kernel_carries_state_across_calls(cuda, S, cut, di,
                                                          ds, dtype):
    """Split inside the first 16-token stage, and a last call of one
    token; d_inner 131 takes the unaligned staging and an odd channel."""
    from repro_torch.kernels.selective_scan import kernel as ssk
    _split_calls(ssk.selective_scan,
                 _scan_inputs(cuda, 2, S, di, ds, dtype, di + cut),
                 (0, 1, 3, 4), cut)


@pytest.mark.parametrize("di,ds", [(256, 16), (300, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_kernel_is_its_ex2_mirror(cuda, di, ds, dtype):
    """The kernel against ``ref.selective_scan_ex2_plain`` (exp2 of the
    pre-scaled A, db's roundings, the FMAs) on CPU copies, within 1e-6 of
    the largest value (ex2.approx's last bits)."""
    from repro_torch.kernels.selective_scan import kernel as ssk
    from repro_torch.kernels.selective_scan.ref import (
        selective_scan_ex2_plain)
    args = _scan_inputs(cuda, 2, 37, di, ds, dtype, 9)
    got = ssk.selective_scan(*args)
    want = selective_scan_ex2_plain(*(a.cpu() for a in args))
    for g, w in zip(got, want):
        assert float((g.cpu() - w).abs().max()) <= 1e-6 * float(
            w.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_kernel_db_is_the_plain_versions(cuda, dtype):
    """A so negative that da is 0, C one-hot on state 5, D = 0, h0 = 0: y
    is db, and the kernel's (bf16: two __hmul2 roundings) equals
    ``selective_scan_plain``'s bit for bit."""
    from repro_torch.kernels.selective_scan import kernel as ssk
    from repro_torch.kernels.selective_scan.ref import selective_scan_plain
    dt, xc, A, Bm, Cm, D, h0 = _scan_inputs(cuda, 2, 40, 256, 16, dtype, 4)
    A = torch.full_like(A, -1e6)
    Cm = torch.zeros_like(Cm)
    Cm[..., 5] = 1
    args = (dt, xc, A, Bm, Cm, torch.zeros_like(D), torch.zeros_like(h0))
    y, _ = ssk.selective_scan(*args)
    want, _ = selective_scan_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(y, want)


@pytest.mark.parametrize("di", [72, 200, 131])
def test_selective_scan_kernel_at_partial_tiles(cuda, di):
    """d_inner that does not fill the CTAs' 128 channels, and dt large
    enough that da underflows on the later states."""
    from repro_torch.kernels.selective_scan import kernel as ssk
    from repro_torch.kernels.selective_scan.ref import selective_scan_plain
    dt, xc, A, Bm, Cm, D, h0 = _scan_inputs(cuda, 2, 21, di, 16,
                                            torch.bfloat16, di)
    args = ((dt.float() * 40 + 20).to(dt.dtype), xc, A, Bm, Cm, D, h0)
    _rec_close(ssk.selective_scan(*args), selective_scan_plain(*args))


# the backward kernels against their plain backward (the same f32 formulas
# from the same inputs; the sums over keys, values, channels and tokens in
# another order, the scan's exponentials on the SFU): each gradient within
# REC_REL of its largest |value|; a bf16 gradient (r, k, v; dt, x, B, C) is
# that f32 value rounded once on each side, so the two may also differ by
# one bf16 ulp of the value (2^-7 of it at most)
BF16_ULP = 2.0 ** -7


def _rec_bwd_close(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert bool(torch.isfinite(g).all())
        g, w32 = g.float(), w.float()
        ulp = BF16_ULP if w.dtype == torch.bfloat16 else 0.0
        bar = REC_REL * float(w32.abs().max()) + ulp * w32.abs()
        assert bool(((g - w32).abs() <= bar).all())


def _wkv_bwd_inputs(cuda, B, S, H, hd, dtype, seed, w_lo=None):
    r, k, v, w, u, s0 = _wkv_inputs(cuda, B, S, H, hd, dtype, seed)
    g = torch.Generator(device=cuda).manual_seed(seed + 1)
    if w_lo is not None:   # decays near 0 and near 1
        lo = torch.rand(w.shape, generator=g, device=cuda) < 0.5
        w = torch.where(lo, torch.full_like(w, w_lo),
                        torch.full_like(w, 1 - w_lo))
    dy = torch.randn((B, S, H, hd), generator=g, device=cuda)
    return r, k, v, w, u, s0, dy


# (B, H) of a backward case by its S: S = 1000 and 1001 at B = 1, H = 2
# span many time segments of the wkv6 backward with a short last one
def _bwd_bh(S):
    return (1, 2) if S >= 1000 else (2, 3)


WKV_BWD_KERNELS = ("bwd", "bwd_local", "bwd_carry")


@pytest.mark.parametrize("S", [1, 37, 300, 1000])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_bwd_kernel_matches_plain(cuda, S, hd, dtype):
    """S = 37 is not a multiple of the backward's 8-token chunk and lies in
    one segment; S = 300 spans several segments; S = 1000 (B = 1, H = 2)
    spans 16 segments of 64 tokens, the last of 40. Each call launches the
    local, carry and main kernels once."""
    from repro_torch.kernels.wkv import kernel as wk
    from repro_torch.kernels.wkv.ref import wkv6_bwd_plain
    B, H = _bwd_bh(S)
    args = _wkv_bwd_inputs(cuda, B, S, H, hd, dtype, S + hd)
    plan = wk.bwd_plan(dtype, B, S, H, hd, cuda)
    n, seg = plan["segments"], plan["segment"]
    assert seg % plan["chunk"] == 0 and (n - 1) * seg < S <= n * seg
    assert n > 1 or S < 128
    before = [wk.launch_count(k) for k in WKV_BWD_KERNELS]
    got = wk.wkv6_bwd(*args)
    assert [wk.launch_count(k) - b
            for k, b in zip(WKV_BWD_KERNELS, before)] == [1, 1, 1]
    _rec_bwd_close(got, wkv6_bwd_plain(*args))


@pytest.mark.parametrize("S", [45, 1000])
@pytest.mark.parametrize("w_lo", [1e-30, 1e-6])
def test_wkv6_bwd_kernel_at_extreme_decays(cuda, w_lo, S):
    """Decays of 1e-30 underflow the segments' decay products to 0."""
    from repro_torch.kernels.wkv import kernel as wk
    from repro_torch.kernels.wkv.ref import wkv6_bwd_plain
    args = _wkv_bwd_inputs(cuda, 2, S, 2, 64, torch.float32, 7, w_lo)
    _rec_bwd_close(wk.wkv6_bwd(*args), wkv6_bwd_plain(*args))


def test_wkv6_bwd_plan_fills_the_card(cuda):
    """At rwkv6-3b's training shape the plan's segments give the main
    kernel at least two CTAs a resident slot; every kernel fits."""
    from repro_torch.kernels.wkv import kernel as wk
    plan = wk.bwd_plan(torch.bfloat16, 4, 2048, 40, 64, cuda)
    assert all(n > 0 for n in plan["resident"].values())
    grid = plan["grid"]["main"]
    slots = plan["resident"]["main"] * plan["sms"]
    assert grid[0] * grid[1] * grid[2] >= 2 * slots
    assert plan["segment"] >= 64 and plan["cluster"] == 2


def test_wkv6_bwd_plan_and_launch_on_every_card(cuda):
    """The launcher prepares each card on its own (shared-memory limit,
    occupancy, SMs): the plan and the backward on every visible card, the
    first card's last, agree with that card's own figures and the plain
    backward."""
    from repro_torch.kernels.wkv import kernel as wk
    from repro_torch.kernels.wkv.ref import wkv6_bwd_plain
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more cards")
    for i in (*range(1, n), 0):
        dev = torch.device("cuda", i)
        plan = wk.bwd_plan(torch.bfloat16, 4, 2048, 40, 64, dev)
        props = torch.cuda.get_device_properties(dev)
        assert plan["sms"] == props.multi_processor_count
        assert all(v > 0 for v in plan["resident"].values())
        args = _wkv_bwd_inputs(dev, 1, 300, 2, 64, torch.bfloat16, 11)
        got = wk.wkv6_bwd(*args)
        assert all(t.device == dev for t in got)
        _rec_bwd_close(got, wkv6_bwd_plain(*args))


def _scan_bwd_inputs(cuda, B, S, di, ds, dtype, seed, dt_scale=1.0):
    dt, *rest = _scan_inputs(cuda, B, S, di, ds, dtype, seed)
    dt = (dt.float() * dt_scale).to(dtype)
    g = torch.Generator(device=cuda).manual_seed(seed + 1)
    return (dt, *rest, torch.randn((B, S, di), generator=g, device=cuda))


@pytest.mark.parametrize("S", [1, 37, 300, 1001])
@pytest.mark.parametrize("di,ds", [(256, 4), (300, 16), (131, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_bwd_kernel_matches_plain(cuda, S, di, ds, dtype):
    """d_inner that does not fill the backward's 64-channel CTAs, d_state
    below 16, S not a multiple of its 8-token checkpoint interval; S = 1001
    at B = 1 ends in a one-token chunk after 125 whole ones."""
    from repro_torch.kernels.selective_scan import kernel as ssk
    from repro_torch.kernels.selective_scan.ref import (
        selective_scan_bwd_plain)
    args = _scan_bwd_inputs(cuda, _bwd_bh(S)[0], S, di, ds, dtype, S + di)
    kernels = ("bwd_ckpt", "bwd", "bwd_reduce")
    before = [ssk.launch_count(k) for k in kernels]
    got = ssk.selective_scan_bwd(*args)
    assert [ssk.launch_count(k) - b for k, b in zip(kernels, before)] == [
        1, 1, 1]
    _rec_bwd_close(got, selective_scan_bwd_plain(*args))


def test_selective_scan_bwd_kernel_at_underflowing_decays(cuda):
    """dt large enough that exp(dt A) underflows to 0 on the later
    states."""
    from repro_torch.kernels.selective_scan import kernel as ssk
    from repro_torch.kernels.selective_scan.ref import (
        selective_scan_bwd_plain)
    args = _scan_bwd_inputs(cuda, 2, 29, 96, 16, torch.float32, 3, 400.0)
    assert float(torch.exp(args[0][..., None] * args[2]).min()) == 0.0
    _rec_bwd_close(ssk.selective_scan_bwd(*args),
                   selective_scan_bwd_plain(*args))


@pytest.mark.parametrize("S", [77, 1001])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_recurrence_bwd_kernels_repeat_bit_for_bit(cuda, dtype, S):
    """No atomics: two calls on the same inputs give the same bits (S =
    1001 at B = 1: many wkv6 segments, the last short; both kernels end
    in a one-token chunk)."""
    from repro_torch.kernels.selective_scan import kernel as ssk
    from repro_torch.kernels.wkv import kernel as wk
    B = _bwd_bh(S)[0]
    for fn, args in (
            (wk.wkv6_bwd, _wkv_bwd_inputs(cuda, B, S, 4, 64, dtype, 5)),
            (ssk.selective_scan_bwd,
             _scan_bwd_inputs(cuda, B, S, 512, 16, dtype, 5))):
        first, second = fn(*args), fn(*args)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_recurrence_functions_on_card_equal_cpu(cuda):
    """The training entries on the card (forward and backward kernels)
    and on the CPU (plain versions), f32: gradients of every input within
    REC_REL of their largest."""
    from repro_torch.kernels.selective_scan import kernel as ssk
    from repro_torch.kernels.wkv import kernel as wk
    for fn, args in (
            (wk.wkv6_train,
             _wkv_bwd_inputs(cuda, 2, 21, 2, 32, torch.float32, 9)),
            (ssk.selective_scan_train,
             _scan_bwd_inputs(cuda, 2, 21, 72, 16, torch.float32, 9))):
        dy = args[-1]
        grads = []
        for dev in (cuda, torch.device("cpu")):
            ins = [a.to(dev).clone().requires_grad_() for a in args[:-1]]
            out = fn(*ins)
            grads.append(torch.autograd.grad(out, ins, dy.to(dev)))
        for g, w in zip(*grads):
            assert float((g.cpu() - w).abs().max()) <= \
                REC_REL * float(w.abs().max())


def test_recurrence_wrappers_raise(cuda):
    from repro_torch.kernels.selective_scan import kernel as ssk
    from repro_torch.kernels.wkv import kernel as wk
    args = _wkv_inputs(cuda, 1, 4, 2, 48, torch.float32, 0)
    with pytest.raises(ValueError, match="head dim"):
        wk.wkv6(*args)
    args = _wkv_inputs(cuda, 1, 4, 2, 32, torch.float32, 0)
    with pytest.raises(ValueError, match="w must be"):
        wk.wkv6(*args[:3], args[3].bfloat16(), *args[4:])
    # under grad mode the call trains through the backward kernels
    r = args[0].clone().requires_grad_()
    before = wk.launch_count("bwd")
    y, s = wk.wkv6(r, *args[1:])
    assert not s.requires_grad
    y.sum().backward()
    assert wk.launch_count("bwd") == before + 1
    assert r.grad is not None and bool(torch.isfinite(r.grad).all())
    with pytest.raises(ValueError, match="in place"):
        wk.wkv6(r, *args[1:], out_state=args[-1].clone())
    args = _scan_inputs(cuda, 1, 4, 64, 16, torch.float32, 0)
    xc = args[1].clone().requires_grad_()
    before = ssk.launch_count("bwd")
    y, h = ssk.selective_scan(args[0], xc, *args[2:])
    assert not h.requires_grad
    y.sum().backward()
    assert ssk.launch_count("bwd") == before + 1
    assert xc.grad is not None and bool(torch.isfinite(xc.grad).all())
    args = _scan_inputs(cuda, 1, 4, 64, 17, torch.float32, 0)
    with pytest.raises(ValueError, match="d_state"):
        ssk.selective_scan(*args)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "jamba-1.5-large-398b", "rwkv6-3b"])
def test_smoke_mixer_lm_on_card_equals_cpu(cuda, arch):
    """A smoke mixer model on the card (flash attention, selective scan,
    wkv6) and the same weights on the CPU (plain versions), f32, MoE
    capacity 4.0: teacher-forced logits within 1e-4 of their scale, and
    prefill plus decode within 1e-4 of the card's teacher-forced logits.
    Training such a model builds on the card (its training is
    ``test_smoke_training_on_card_equals_cpu``)."""
    import dataclasses

    from repro_torch.kernels.selective_scan import kernel as ssk
    from repro_torch.kernels.wkv import kernel as wk
    cfg = configs.smoke(arch).with_(act_dtype="float32")
    if cfg.moe is not None:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=4.0))
    cpu = transformer.DecoderLM(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(3))
    gpu = transformer.DecoderLM(cfg, generator=torch.Generator(
        device=cuda).manual_seed(4))
    gpu.load_state_dict(cpu.state_dict())
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 40))
    n = {"m": cfg.pattern.count("m"), "r": cfg.pattern.count("r")}
    before = (ssk.launch_count(), wk.launch_count())
    got = transformer.forward(gpu, torch.as_tensor(toks, device=cuda))
    G = cfg.n_groups
    assert (ssk.launch_count() - before[0], wk.launch_count() - before[1]) \
        == (G * n["m"], G * n["r"])
    want = transformer.forward(cpu, torch.as_tensor(toks))
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) / scale < 1e-4
    P = 34
    lg, cache = transformer.prefill(gpu, torch.as_tensor(toks[:, :P],
                                                         device=cuda), 40)
    errs = [float((lg[:, 0] - got[:, P - 1]).abs().max())]
    for i in range(P, 39):
        lg, cache = transformer.decode_step(
            gpu, cache, torch.as_tensor(toks[:, i:i + 1], device=cuda))
        errs.append(float((lg[:, 0] - got[:, i]).abs().max()))
    assert max(errs) / scale < 1e-4, errs
    assert transformer.DecoderLM(cfg, train=True).embed.requires_grad


def test_smoke_encdec_on_card_equals_cpu(cuda):
    """seamless-m4t's smoke encoder-decoder on the card (flash attention:
    encoder, decoder and cross attention) and the same weights on the
    CPU, f32: teacher-forced logits within 1e-4 of their scale, and
    prefill plus decode steps within 1e-4 of the card's teacher-forced
    logits; one launch an attention."""
    cfg = configs.smoke("seamless-m4t-large-v2").with_(act_dtype="float32")
    cpu = encdec.EncDecLM(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(3))
    gpu = encdec.EncDecLM(cfg, generator=torch.Generator(
        device=cuda).manual_seed(4))
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(5)
    frames = rng.standard_normal((2, 33, cfg.frontend_dim), dtype=np.float32)
    toks = rng.integers(0, cfg.vocab, (2, 24))
    fg, tg = (torch.as_tensor(a, device=cuda) for a in (frames, toks))
    before = fak.launch_count()
    got = encdec.forward(gpu, fg, tg)
    assert fak.launch_count() == before + cfg.encoder_layers + \
        2 * cfg.n_layers
    want = encdec.forward(cpu, torch.as_tensor(frames), torch.as_tensor(toks))
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) / scale < 1e-4
    P = 16
    lg, cache = encdec.prefill(gpu, fg, tg[:, :P], 24)
    errs = [float((lg[:, 0] - got[:, P - 1]).abs().max())]
    for i in range(P, 23):
        before = fak.launch_count("decode")
        lg, cache = encdec.decode_step(gpu, cache, tg[:, i:i + 1])
        assert fak.launch_count("decode") == before + 2 * cfg.n_layers
        errs.append(float((lg[:, 0] - got[:, i]).abs().max()))
    assert max(errs) / scale < 1e-4, errs


def test_smoke_frontend_on_card_equals_cpu(cuda):
    """internvl2's smoke model with a patch-embedding prefix on the card
    and the same weights on the CPU, f32: teacher-forced logits within
    1e-4 of their scale, prefill plus decode within 1e-4 of the card's
    teacher-forced logits."""
    cfg = configs.smoke("internvl2-26b").with_(act_dtype="float32")
    cpu = transformer.DecoderLM(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(3))
    gpu = transformer.DecoderLM(cfg, generator=torch.Generator(
        device=cuda).manual_seed(4))
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(6)
    pre = rng.standard_normal((2, cfg.frontend_seq, cfg.frontend_dim),
                              dtype=np.float32)
    toks = rng.integers(0, cfg.vocab, (2, 24))
    pg, tg = (torch.as_tensor(a, device=cuda) for a in (pre, toks))
    got = transformer.forward(gpu, tg, pg)
    want = transformer.forward(cpu, torch.as_tensor(toks),
                               torch.as_tensor(pre))
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) / scale < 1e-4
    P, n = 16, cfg.frontend_seq
    lg, cache = transformer.prefill(gpu, tg[:, :P], n + 24, prefix_embed=pg)
    errs = [float((lg[:, 0] - got[:, n + P - 1]).abs().max())]
    for i in range(P, 23):
        lg, cache = transformer.decode_step(gpu, cache, tg[:, i:i + 1])
        errs.append(float((lg[:, 0] - got[:, n + i]).abs().max()))
    assert max(errs) / scale < 1e-4, errs
