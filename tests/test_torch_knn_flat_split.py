"""The flat kNN kernel's split and merge on the CPU.

``repro_torch.kernels.knn.ref.knn_flat_split_plain`` spells what the CUDA
kernel (``csrc/knn_flat.cu``) computes: the slots cut into ranges, a
top-k by ``(d2, slot)`` per range, the ranges' lists merged in range
order. Here it is held bit for bit against the reference's oracle
(``repro.kernels.knn.ref.knn_ref``, whose ``lax.top_k`` keeps the lowest
index first among equal distances) and the port's ``knn_flat_plain``,
on tie-free data, on duplicated points whose ties straddle a range
boundary, with fewer valid slots than k, and at k = 1 and k = 128.
Coordinates are integers, exact in f32, so the reference's jnp sum and
the direct form agree exactly. ``split_plan`` is checked at the flat
phase's shape.

    PYTHONPATH=src python -m pytest -q tests/test_torch_knn_flat_split.py
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.knn import ref as jkref
from repro_torch.kernels.knn import kernel as kk
from repro_torch.kernels.knn import ref as kref

torch.set_num_threads(1)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _check(q, p, ok, k, splits):
    got = kref.knn_flat_split_plain(torch.as_tensor(q), torch.as_tensor(p),
                                    torch.as_tensor(ok), k=k, splits=splits)
    plain = kk.knn_flat_plain(torch.as_tensor(q), torch.as_tensor(p),
                              torch.as_tensor(ok), k=k)
    for g, w in zip(got, plain):
        _eq(g.numpy(), w.numpy())
    n = p.shape[0]
    if k <= n:   # lax.top_k refuses k > N
        want = jkref.knn_ref(jnp.asarray(q), jnp.asarray(p), jnp.asarray(ok),
                             k=k)
        for g, w in zip(got, want):
            _eq(g.numpy(), w)
    return got


@pytest.mark.parametrize("Q,N,dim,k,splits", [
    (50, 700, 2, 10, 5), (33, 1000, 3, 4, 17), (64, 300, 1, 1, 3),
    (20, 2000, 2, 128, 6), (9, 130, 2, 16, 2), (40, 999, 3, 17, 40)])
def test_split_plain_tie_free(Q, N, dim, k, splits):
    """Distinct points on a wide grid: no two distances of a query tie
    near its k-th, so any order of the same set would show."""
    rng = np.random.default_rng(Q + N)
    p = rng.choice(1 << 22, size=N, replace=False)
    p = np.stack([(p >> (11 * d)) % 2048 for d in range(dim)], 1) * 97
    q = rng.integers(0, 2048 * 97, (Q, dim))
    ok = rng.random(N) > 0.3
    _check(q.astype(np.int32), p.astype(np.int32), ok, k, splits)


@pytest.mark.parametrize("splits", [2, 3, 8, 31])
@pytest.mark.parametrize("k", [1, 5, 128])
def test_split_plain_ties_straddle_splits(splits, k):
    """Runs of copies of a few points laid across the range boundaries:
    equal distances on both sides of a boundary must keep slot order."""
    rng = np.random.default_rng(splits * 7 + k)
    base = rng.integers(0, 8, (12, 2))
    N = 1000
    p = base[rng.integers(0, 12, N)]
    per = kref.split_size(N, splits)
    for b in range(per, N, per):          # the same point on both sides
        p[b - 3: b + 3] = base[0]
    q = np.concatenate([base[:1], rng.integers(0, 8, (30, 2))])
    ok = rng.random(N) > 0.05
    got = _check(q.astype(np.int32), p.astype(np.int32), ok, k, splits)
    assert (got[1] >= 0).all()


@pytest.mark.parametrize("N,k,splits", [(5, 10, 1), (40, 128, 3),
                                        (64, 20, 2), (0, 3, 1)])
def test_split_plain_fewer_valid_than_k(N, k, splits):
    rng = np.random.default_rng(N + k)
    p = rng.integers(0, 64, (N, 2)).astype(np.int32)
    ok = rng.random(N) > 0.5
    q = rng.integers(0, 64, (7, 2)).astype(np.int32)
    d2, ids = _check(q, p, ok, k, splits)
    n_ok = int(ok.sum())
    assert (ids[:, n_ok:] == -1).all() and (d2[:, n_ok:] >= 3.4e38).all()
    assert (ids[:, :n_ok] >= 0).all()


def test_split_plan_fills_the_card():
    """At the flat phase's shape (4096 queries, 20,480 slots, k = 10) on
    132 SMs the grid is at least 4 CTAs an SM; the ranges cover the slots
    exactly; shared-memory lists take one warp a CTA."""
    threads, splits, per = kk.split_plan(4096, 20480, 10, 132)
    assert threads == 128 and per % 32 == 0
    assert -(-4096 // threads) * splits >= 4 * 132
    assert (splits - 1) * per < 20480 <= splits * per
    assert kk.split_plan(4096, 20480, 128, 132)[0] == 32
    assert kk.split_plan(5, 40, 3, 132) == (128, 2, 32)
    assert kk.split_plan(5, 0, 3, 132)[1] == 1
    assert kk.split_plan(5, 30000, 3, 132)[1] <= kk.MAX_SPLITS
