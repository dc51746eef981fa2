"""Port parity for the kNN kernels' plain PyTorch versions and the
frontier prep, against the reference's oracles (``knn_ref``,
``prepare``, ``knn_frontier_ref``), mirroring tests/test_kernels.py.

On a CPU tensor each wrapper takes its plain version, which is what runs
here. Coordinates are integers in the f32-exact window, so the direct
``(q - p)^2`` form and the reference's matrix identities agree exactly
and answers are compared bit for bit (ties included: both keep the
lowest id first). The CUDA kernels themselves are compared with these
plain versions on the card by tests/test_torch_cuda.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.frontier import knn_frontier_impl as j_frontier_impl
from repro.kernels.frontier import prep as jprep
from repro.kernels.frontier import ref as jfref
from repro.kernels.knn import ref as jkref
from repro_torch.kernels.frontier import kernel as fk
from repro_torch.kernels.frontier import ops as fops
from repro_torch.kernels.frontier import prep
from repro_torch.kernels.knn import kernel as kk

torch.set_num_threads(1)


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# flat kNN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Q,N,dim,k", [(64, 500, 2, 8), (33, 1024, 3, 4),
                                       (128, 256, 2, 16), (9, 5, 2, 12)])
def test_knn_flat_plain_matches_knn_ref(Q, N, dim, k):
    rng = np.random.default_rng(4)
    qs = rng.integers(0, 1 << 10, (Q, dim)).astype(np.int32)
    ps = rng.integers(0, 1 << 6, (N, dim)).astype(np.int32)  # many ties
    ok = rng.random(N) > 0.1
    before = kk.launch_count()
    d2, idx = kk.knn_flat(torch.as_tensor(qs), torch.as_tensor(ps),
                          torch.as_tensor(ok), k=k)
    assert kk.launch_count() == before      # the CPU takes the plain path
    if k <= N:
        d_w, i_w = jkref.knn_ref(jnp.asarray(qs), jnp.asarray(ps),
                                 jnp.asarray(ok), k=k)
        _eq(d2, d_w)
        _eq(idx, i_w)
    else:   # lax.top_k refuses k > N; the plain version pads
        d_w, i_w = jkref.knn_ref(jnp.asarray(qs), jnp.asarray(ps),
                                 jnp.asarray(ok), k=N)
        _eq(d2[:, :N], d_w)
        _eq(idx[:, :N], i_w)
        assert (idx[:, N:] == -1).all() and (d2[:, N:] >= 3.4e38).all()


def test_knn_flat_plain_float_data():
    """Float coordinates: the direct form may round differently from
    the reference's jnp sum, so distances agree to 1e-6 relative and
    ids wherever the oracle has no near-tie."""
    rng = np.random.default_rng(5)
    qs = rng.random((40, 3)).astype(np.float32)
    ps = rng.random((700, 3)).astype(np.float32)
    ok = np.ones(700, bool)
    d2, _ = kk.knn_flat_plain(torch.as_tensor(qs), torch.as_tensor(ps),
                              torch.as_tensor(ok), k=6)
    d_w, _ = jkref.knn_ref(jnp.asarray(qs), jnp.asarray(ps),
                           jnp.asarray(ok), k=6)
    np.testing.assert_allclose(d2.numpy(), np.asarray(d_w), rtol=1e-6)


# ---------------------------------------------------------------------------
# frontier kNN
# ---------------------------------------------------------------------------

CASES = [
    (37, 16, 2, 33, 8, 8, 64),      # ragged everything
    (64, 8, 3, 16, 4, 16, 128),     # 3-d, whole blocks
    (5, 4, 2, 7, 32, 8, 8),         # k > live points
]


def _leaf_data(R, C, dim, Q, seed=11):
    rng = np.random.default_rng(seed)
    pts = rng.integers(0, 1 << 10, (R, C, dim)).astype(np.int32)
    valid = rng.random((R, C)) > 0.2
    active = rng.random(R) > 0.1
    lo = np.where(valid[..., None], pts, 1 << 30).min(axis=1).astype(np.int32)
    hi = np.where(valid[..., None], pts, -1).max(axis=1).astype(np.int32)
    q = rng.integers(0, 1 << 10, (Q, dim)).astype(np.int32)
    return pts, valid, active, lo, hi, q


@pytest.mark.parametrize("R,C,dim,Q,k,bq,bp", CASES)
def test_prepare_bit_equal(R, C, dim, Q, k, bq, bp):
    args = _leaf_data(R, C, dim, Q)
    want = jprep.prepare(*map(jnp.asarray, args), block_q=bq, block_p=bp)
    got = prep.prepare(*map(torch.as_tensor, args), block_q=bq, block_p=bp)
    for name in ("qs", "order", "glb", "inv"):
        _eq(getattr(got, name), getattr(want, name))
    assert got.points_per_group == want.points_per_group
    assert got.block_q == want.block_q


@pytest.mark.parametrize("R,C,dim,Q,k,bq,bp", CASES)
def test_frontier_plain_walk_matches_ref(R, C, dim, Q, k, bq, bp):
    """The plain walk visits the reference's prefix and returns its raw
    (sorted-query order) top-k bit for bit."""
    args = _leaf_data(R, C, dim, Q)
    jpr = jprep.prepare(*map(jnp.asarray, args), block_q=bq, block_p=bp)
    d_w, i_w = jfref.knn_frontier_ref(jpr, k=k)
    t = [torch.as_tensor(a) for a in args]
    pr = prep.prepare(*t, block_q=bq, block_p=bp)
    before = fk.launch_count()
    d2, ids, steps = fk.knn_frontier(pr, t[0], t[1], t[2], k=k)
    assert fk.launch_count() == before      # the CPU takes the plain path
    _eq(d2, d_w)
    _eq(ids, i_w)
    assert steps.shape == (pr.order.shape[0],)
    assert (steps >= 1).all() and (steps <= pr.order.shape[1]).all()


@pytest.mark.parametrize("R,C,dim,Q,k,bq,bp", CASES)
@pytest.mark.parametrize("impl", ["plain", "cuda"])
def test_frontier_impl_matches_reference_impl(R, C, dim, Q, k, bq, bp,
                                              impl):
    args = _leaf_data(R, C, dim, Q, seed=12)
    d_w, i_w = j_frontier_impl(*map(jnp.asarray, args), k=k, impl="ref",
                               block_q=bq, block_p=bp)
    d2, ids = fops.knn_frontier_impl(*map(torch.as_tensor, args), k=k,
                                     impl=impl, block_q=bq, block_p=bp)
    _eq(d2, d_w)
    _eq(ids, i_w)


def test_impl_spellings_are_checked():
    z = torch.zeros((4, 4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown frontier impl"):
        fops.knn_frontier_impl(z, torch.ones((4, 4), dtype=torch.bool),
                               torch.ones(4, dtype=torch.bool), z[:, 0],
                               z[:, 0], z[:, 0], k=2, impl="pallas")
