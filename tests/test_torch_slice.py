"""The slice end to end: one trace replayed through the reference's
``repro.serving.SpatialServer`` and the port's, in the pipelined serving
pattern (snapshot; delete + insert dispatched; micro-batched kNN and
range-count requests answered against the snapshot; commit).

Coordinates lie in [0, 2^11), so every squared distance is an integer
below 2^23 and exact in f32: the two stacks must agree bit for bit on
every answer and on every tree field after every commit. The small index
takes the flat route and the large one the frontier route, so both kNN
kernels' plain versions are on the compared path.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import points as jgen
from repro.serving import MicroBatcher as JBatcher
from repro.serving import SpatialServer as JServer
from repro_torch.core import spac
from repro_torch.serving import MicroBatcher, SpatialServer

torch.set_num_threads(1)

HI = 1 << 11
K, QUERIES = 5, 32


@pytest.mark.parametrize("n,route", [(1500, "flat:cuda"),
                                     (5000, "frontier-kernel:cuda")])
def test_trace_through_both_servers(n, route):
    trace = jgen.make_trace("uniform", seed=1, n=n, batch=256, steps=3,
                            hi=HI)
    boot = np.asarray(trace.bootstrap)
    kw = dict(phi=8, capacity_points=trace.max_live, coord_bits=11)
    ref = JServer.build("spac-h", jnp.asarray(boot), **kw)
    srv = SpatialServer.build("spac-h", boot, device="cpu", **kw)
    jmb = JBatcher(max_batch=QUERIES, max_delay_s=1e9)
    mb = MicroBatcher(max_batch=QUERIES, max_delay_s=1e9)
    rng = np.random.default_rng(2)
    for step in trace.steps:
        jmb.target, mb.target = ref.snapshot(), srv.snapshot()
        dele, ins = np.asarray(step.delete), np.asarray(step.insert)
        ref.delete(jnp.asarray(dele))
        srv.delete(dele)
        ref.insert(jnp.asarray(ins))
        srv.insert(ins)
        qs = rng.integers(0, HI, size=(QUERIES, 2)).astype(np.int32)
        lo = rng.integers(0, HI - 256, size=(QUERIES, 2)).astype(np.int32)
        hi = lo + rng.integers(0, 256, size=(QUERIES, 2)).astype(np.int32)
        want = [jmb.submit_knn(q, K) for q in qs]
        got = [mb.submit_knn(q, K) for q in qs]
        want_c = [jmb.submit_range_count(a, b) for a, b in zip(lo, hi)]
        got_c = [mb.submit_range_count(a, b) for a, b in zip(lo, hi)]
        for w, g in zip(want, got):
            for wa, ga in zip(w.result(), g.result()):
                np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
        np.testing.assert_array_equal(
            np.concatenate([g.result().numpy() for g in got_c]),
            np.concatenate([np.asarray(w.result()) for w in want_c]))
        assert ref.commit() == srv.commit()
        got_tree = srv.head_index.tree.to_numpy()
        for f in spac.FIELDS:
            np.testing.assert_array_equal(
                got_tree[f], np.asarray(getattr(ref.head_index.tree, f)),
                err_msg=f)
    assert len(srv.head_index) == len(ref.head_index) == n + 3 * (
        256 - 64)
    assert srv.head_index.engine.route_counts == {route: 3}
    assert srv.stats == ref.stats
