"""The port on the card: each CUDA kernel against its plain PyTorch
version on the same CUDA tensors (bit-equal; flash attention, whose
softmax sums run in another order, at 2e-5 in f32 and, in bf16, at
1e-2 relative (about one bf16 ulp) and 1e-4 absolute), the engine's
``auto`` routes through the kernels, P-Orth, kd, Zd and spac-z trees
built and updated on the card equal to the same trees on the CPU, a
sync-free ``server.insert``, and a smoke LM on the card equal to the
same weights on the CPU.

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
from repro_torch.kernels.flash_attn import kernel as fak
from repro_torch.kernels.flash_attn.ref import attention_plain
from repro_torch.kernels.frontier import kernel as fk
from repro_torch.kernels.frontier import prep
from repro_torch.kernels.knn import kernel as kk
from repro_torch.kernels.morton import kernel as mk
from repro_torch.kernels.sieve import kernel as sk
from repro_torch.kernels.sieve import ops as sieve_ops
from repro_torch.kernels.sieve import ref as sieve_ref
from repro_torch.models import transformer
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


@pytest.mark.parametrize("dtype,n,dim,lam,block_n", [
    (torch.int32, 100_000, 2, 3, 1024), (torch.float32, 50_000, 2, 3, 256),
    (torch.int32, 30_000, 3, 2, 1024), (torch.float32, 7, 3, 2, 4096),
    (torch.int32, 5000, 2, 5, 512)])
def test_sieve_kernels_bit_equal(cuda, dtype, n, dim, lam, block_n):
    """Both sieve kernels against their plain versions over random
    segments (some inactive), and the reference-shaped histogram and
    partition on the card against the same calls on the CPU (the plain
    versions)."""
    rng = np.random.default_rng(n + lam)
    pts, lo, hi = _sieve_state(rng, dtype, n, dim, cuda)
    starts = np.unique(np.concatenate([[0], rng.integers(0, n, 60)]))
    which = np.searchsorted(starts, np.arange(n), side="right") - 1
    seg = torch.as_tensor(starts[which].astype(np.int32), device=cuda)
    act = torch.as_tensor((rng.random(starts.shape[0]) < 0.7)[which],
                          device=cuda)
    m = n // block_n + starts.shape[0] + 1
    cs, cl = sieve_ops.segment_chunks(seg, act, block_n=block_n, n_chunks=m)
    before = sk.launch_count()
    hist = sk.sieve_histogram_chunks(pts, lo, hi, cs, cl, lam=lam)
    assert sk.launch_count() == before + 1
    _equal((hist,), (sieve_ref.sieve_histogram_plain(pts, lo, hi, cs, cl,
                                                     lam=lam),))
    off = sieve_ops.chunk_offsets(hist, cs, cl, seg[cs.clamp(max=n - 1)])
    got = sk.sieve_rank_chunks(pts, lo, hi, cs, cl, off, lam=lam,
                               block_n=block_n)
    _equal(got, sieve_ref.sieve_rank_plain(pts, lo, hi, cs, cl, off,
                                           lam=lam))
    for fn in (sieve_ops.sieve_histogram, sieve_ops.sieve_partition):
        got = fn(pts, lo, hi, lam=lam, block_n=block_n)
        want = fn(pts.cpu(), lo.cpu(), hi.cpu(), lam=lam, block_n=block_n)
        _equal([g.cpu() for g in got], want)


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
