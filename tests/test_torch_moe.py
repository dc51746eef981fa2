"""The port's MoE block (``repro_torch/models/moe.py``) against the JAX
package's dense-dispatch path at f32, on the same numpy inputs and
weights: ``moe_block`` over several capacity groups (T above
``moe_group``, a ragged last group padded as the reference pads it),
with drops (capacity 1.25) and without (4.0), within 1e-5 of the output's
scale (f32 sums in another order; the routing is the same because the
router's probabilities agree far closer than any gap between them);
``_rank_in_expert`` exactly equal on random ids with ties; and router
ties broken to the lowest expert index, as ``jax.lax.top_k`` breaks
them."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.models import moe

torch.set_num_threads(1)

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(arch, capacity, group):
    cfg = configs.smoke(arch).with_(act_dtype="float32", moe_group=group)
    jcfg = jconfigs.smoke(arch).with_(act_dtype="float32", moe_group=group)
    return (cfg.with_(moe=dataclasses.replace(cfg.moe,
                                              capacity_factor=capacity)),
            jcfg.with_(moe=dataclasses.replace(jcfg.moe,
                                               capacity_factor=capacity)))


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "qwen3-moe-235b-a22b"])
@pytest.mark.parametrize("capacity", [1.25, 4.0])
def test_moe_block_matches_reference(arch, capacity):
    """B x S = 2 x 37 = 74 tokens in groups of 32 (3 groups, the last
    padded with 22 zero rows)."""
    cfg, jcfg = _cfgs(arch, capacity, 32)
    p = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(3), jcfg,
                                               jnp.float32))
    x = np.random.default_rng(4).standard_normal(
        (2, 37, cfg.d_model), dtype=np.float32)
    want = np.asarray(jmoe.moe_block(jnp.asarray(x), p, jcfg))
    got = moe.moe_block(torch.from_numpy(x),
                        {k: _t(v) for k, v in p.items()}, cfg)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * scale)


def test_moe_group_drops_as_the_reference():
    """With capacity 1.0 (C = int(32 * 2 * 1.0 / 4) = 16 slots an expert)
    this group's busiest expert gets 20 pairs: the last 4 drop in both."""
    cfg, jcfg = _cfgs("phi3.5-moe-42b-a6.6b", 1.0, 32)
    p = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(5), jcfg,
                                               jnp.float32))
    xg = np.random.default_rng(6).standard_normal((32, cfg.d_model),
                                                  dtype=np.float32)
    _, topi = moe._route(torch.from_numpy(xg), _t(p["wr"]), 2)
    counts = np.bincount(topi.numpy().ravel(), minlength=4)
    assert counts.max() > 16, counts          # this input drops
    got = moe._moe_group(torch.from_numpy(xg),
                         {k: _t(v) for k, v in p.items()},
                         cfg.moe)
    want = np.asarray(jmoe._moe_group(jnp.asarray(xg), p, jcfg, jcfg.moe))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL * float(np.abs(want).max()))


@pytest.mark.parametrize("n,n_buckets,seed", [(1, 4, 0), (64, 4, 1),
                                              (257, 16, 2), (4096, 128, 3)])
def test_rank_in_expert_equal(n, n_buckets, seed):
    ids = np.random.default_rng(seed).integers(0, n_buckets, n).astype(
        np.int32)
    got = moe._rank_in_expert(torch.from_numpy(ids.astype(np.int64)))
    want = np.asarray(jmoe._rank_in_expert(jnp.asarray(ids), n_buckets))
    np.testing.assert_array_equal(got.numpy(), want)


def test_router_ties_go_to_the_lowest_index():
    """Zero router weights give every expert the same probability: both
    packages pick experts 0..K-1 in order with equal weights; rows with a
    tie between two experts behind a clear winner pick the lower one."""
    D, E, K = 8, 16, 2
    x = np.random.default_rng(7).standard_normal((5, D), dtype=np.float32)
    wr = np.zeros((D, E), np.float32)
    w, i = moe._route(torch.from_numpy(x), torch.from_numpy(wr), K)
    jw, ji = jmoe._route(jnp.asarray(x), jnp.asarray(wr), K)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(i.numpy(), np.tile(np.arange(K), (5, 1)))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-7)
    # expert 9 wins, experts 3 and 12 tie for second (x[:, 0] = 1)
    x = np.zeros((3, D), np.float32)
    x[:, 0] = 1.0
    wr = np.zeros((D, E), np.float32)
    wr[0, 9], wr[0, 3], wr[0, 12] = 2.0, 1.0, 1.0
    _, i = moe._route(torch.from_numpy(x), torch.from_numpy(wr), K)
    _, ji = jmoe._route(jnp.asarray(x), jnp.asarray(wr), K)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(i.numpy(), np.tile([9, 3], (3, 1)))
