"""The frontier kernel's split arithmetic on the CPU.

``knn_frontier_split_plain`` spells what the CUDA kernel computes: the
visit sequence dealt to several walkers under a shared conservative bound,
each walker's top-k keyed by ``(d2, visit position)``, the lists merged by
that key. Here it is held bit for bit against the plain walk
(``knn_frontier_plain``) and against the reference's oracle
(``repro.kernels.frontier.ref.knn_frontier_ref``) on the same numpy
inputs, on data built to break a wrong tie order: coordinates from 16
values with duplicated points (ties at the k-th distance are common), and
P-Orth-like rows holding one or two points of 64 among inactive rows.
Coordinates are small integers, exact in f32, so the reference's centered
identity and the direct ``(q - p)^2`` agree exactly.

    PYTHONPATH=src python -m pytest -q tests/test_torch_frontier_split.py
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.frontier import prep as jprep
from repro.kernels.frontier import ref as jfref
from repro_torch.kernels.frontier import kernel as fk
from repro_torch.kernels.frontier import prep

torch.set_num_threads(1)

BLOCK_Q = 8


def _ties(dim: int, dtype, seed: int):
    """Dense rows of points from a 16-value range, a quarter of them
    copies of others; a few invalid slots and inactive rows."""
    rng = np.random.default_rng(seed)
    R, C, Q = 48, 16, 37
    pts = rng.integers(0, 16, (R * C, dim))
    dup = rng.random(R * C) < 0.25
    pts[dup] = pts[rng.integers(0, R * C, int(dup.sum()))]
    pts = np.sort(pts, axis=0).reshape(R, C, dim)   # spatially tight rows
    valid = rng.random((R, C)) > 0.15
    active = rng.random(R) > 0.1
    q = rng.integers(0, 16, (Q, dim))
    return pts.astype(dtype), valid, active, q.astype(dtype), 64


def _sparse(dim: int, dtype, seed: int):
    """P-Orth-like rows: one or two valid slots of 64, anywhere in the
    row, and a fifth of the rows inactive."""
    rng = np.random.default_rng(seed)
    R, C, Q = 120, 64, 29
    pts = rng.integers(0, 16, (R, C, dim))
    valid = np.zeros((R, C), bool)
    n = rng.integers(1, 3, R)
    for r in range(R):
        valid[r, rng.choice(C, n[r], replace=False)] = True
    active = rng.random(R) > 0.2
    q = rng.integers(0, 16, (Q, dim))
    return pts.astype(dtype), valid, active, q.astype(dtype), 128


DATA = {"ties": _ties, "sparse": _sparse}


@functools.lru_cache(maxsize=None)
def _case(data: str, dim: int, dtype: str, k: int):
    """Inputs, prep and both references, built once per case and shared
    by the splits."""
    pts, valid, active, q, bp = DATA[data](dim, np.dtype(dtype),
                                           seed=dim * 7 + len(data))
    big = np.iinfo(np.int32).max if dtype == "int32" else np.inf
    lo = np.where(valid[..., None], pts, big).min(axis=1).astype(dtype)
    hi = np.where(valid[..., None], pts, -big).max(axis=1).astype(dtype)
    args = (pts, valid, active, lo, hi, q)
    jpr = jprep.prepare(*map(jnp.asarray, args), block_q=BLOCK_Q,
                        block_p=bp)
    want = tuple(np.asarray(a) for a in jfref.knn_frontier_ref(jpr, k=k))
    t = [torch.as_tensor(a) for a in args]
    pr = prep.prepare(*t, block_q=BLOCK_Q, block_p=bp)
    plain = fk.knn_frontier_plain(pr, t[0], t[1], t[2], k=k)
    return pr, t, want, plain


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("k", [1, 10, 100])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("dim", [1, 2, 3])
@pytest.mark.parametrize("data", ["ties", "sparse"])
def test_split_walk_equals_plain_and_reference(data, dim, dtype, k, splits):
    pr, t, want, plain = _case(data, dim, dtype, k)
    d2, ids, steps = fk.knn_frontier_split_plain(pr, t[0], t[1], t[2], k=k,
                                                 splits=splits)
    assert torch.equal(d2, plain[0]) and torch.equal(ids, plain[1])
    np.testing.assert_array_equal(d2.numpy(), want[0])
    np.testing.assert_array_equal(ids.numpy(), want[1])
    assert steps.shape == plain[2].shape
    assert (steps >= plain[2]).all()
    assert (steps <= pr.order.shape[1]).all()


def test_data_is_tie_heavy_and_sparse():
    """The cases exercise what they claim: the k-th distance is tied
    with the next candidate in many rows, and sparse rows hold 1-2
    points."""
    pr, t, _, plain = _case("ties", 2, "int32", 10)
    d2 = plain[0]
    full = d2[:, -1] < 3.4e38
    assert full.all()
    pts, valid, active, lo, hi, q = t
    live = pts[valid & active[:, None]].float()
    qs = pr.qs
    all_d2 = ((qs[:, None, :] - live[None]) ** 2).sum(-1)
    tied = (all_d2 == d2[:, -1:]).sum(1) > (d2 == d2[:, -1:]).sum(1)
    assert tied.float().mean() > 0.5
    _, t, _, _ = _case("sparse", 2, "int32", 10)
    per_row = t[1].sum(1)
    assert per_row.min() >= 1 and per_row.max() <= 2
    assert (~t[2]).any()


def test_one_split_is_the_plain_walk():
    """With one walker the split walk scores exactly the plain prefix;
    its reach also counts the claim that failed the bound (none where the
    walk ran to the last group)."""
    pr, t, _, plain = _case("sparse", 3, "float32", 10)
    d2, ids, steps = fk.knn_frontier_split_plain(pr, t[0], t[1], t[2], k=10,
                                                 splits=1)
    assert torch.equal(d2, plain[0]) and torch.equal(ids, plain[1])
    G = pr.order.shape[1]
    assert torch.equal(steps, (plain[2] + 1).clamp(max=G))
    assert (plain[2] < G).any()
