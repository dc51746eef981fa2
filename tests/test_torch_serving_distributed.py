"""Distributed serving on the port: the serving contract
(``tests/test_torch_serving.py``) held when the server's head is a
``DistributedIndex`` over ``simulate_mesh(8, device="cpu")``, the three
cases of ``tests/test_serving_distributed.py`` in-process:

* snapshot isolation: micro-batched answers against a snapshot equal a
  single-device server's bit for bit while updates are in flight behind
  it, for every mesh-capable kind;
* the deferred checks replay from the committed base when a shard
  overflows (``capacity_rows=24``) or the routing slab drops entries;
* the batcher's pow2 coalescing keeps the retrace bound across the
  distributed merge: warm rounds build no plan.

Then the driver's ``--mesh`` (the ``distributed`` payload section and
the ``server.shard<i>.live_points`` gauges) and the gate's ``dist``
suite.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.configs import platform
from repro_torch.core import engine
from repro_torch.data import points as gen
from repro_torch.obs import regress
from repro_torch.serving import driver
from repro_torch.serving.batcher import MicroBatcher
from repro_torch.serving.server import SpatialServer

torch.set_num_threads(1)

LANES = 8


@pytest.fixture(scope="module")
def mesh():
    return platform.simulate_mesh(LANES, device="cpu")


@pytest.mark.parametrize("kind", ["spac-h", "spac-z", "porth"])
def test_snapshot_answers_equal_a_single_device_server(mesh, kind):
    N, Q, K, B = 2048, 16, 5, 8
    pts = gen.uniform(0, N, 2)
    qs = gen.uniform(2, Q, 2)
    lo, hi = gen.query_boxes(3, B, 2, gen.DEFAULT_HI // 8)
    newp = gen.uniform(4, 256, 2)

    solo = SpatialServer.build(kind, pts, phi=8, window=3, device="cpu")
    solo_d2, solo_pts, _ = solo.snapshot().knn_points(qs, K)
    solo_cnt = solo.snapshot().range_count(lo, hi)

    srv = SpatialServer.build(kind, pts, mesh=mesh, phi=8, window=3)
    snap = srv.snapshot()
    bat = MicroBatcher(snap, max_batch=1024, max_delay_s=60.0)
    knn_tk = [bat.submit_knn(qs[i], K) for i in range(Q)]
    cnt_tk = [bat.submit_range_count(lo[i], hi[i]) for i in range(B)]
    # updates dispatched *after* the snapshot: the answers below still
    # come from the pre-update version
    srv.insert(newp)
    srv.delete(pts[:256])
    for i, t in enumerate(knn_tk):
        d2, nbrs, ok = t.result()
        assert torch.equal(d2[0], solo_d2[i]), (kind, i)
        assert torch.equal(nbrs[0], solo_pts[i]), (kind, i)
        assert bool(ok.all())
    for i, t in enumerate(cnt_tk):
        assert int(t.result()[0]) == int(solo_cnt[i]), (kind, i)
    srv.commit()
    assert len(srv.head_index) == N
    assert srv.stats["recoveries"] == 0
    # the committed head equals a single-device server given the same ops
    solo.insert(newp)
    solo.delete(pts[:256])
    solo.commit()
    d2, _, _ = srv.snapshot().knn(qs, K)
    assert torch.equal(d2, solo.snapshot().knn_points(qs, K)[0])
    assert torch.equal(srv.snapshot().range_count(lo, hi).long(),
                       solo.snapshot().range_count(lo, hi).long())


def test_shard_overflow_is_replayed_at_commit(mesh):
    pts = gen.uniform(0, 1024, 2)
    # tight per-shard rows: the dispatch-only inserts overflow a shard,
    # the sticky flag rides the lineage, and the next barrier (window
    # eviction or commit) replays from the committed base
    srv = SpatialServer.build("spac-h", pts, mesh=mesh, phi=8, window=2,
                              capacity_rows=24)
    total = 1024
    for r in range(4):
        srv.insert(gen.uniform(10 + r, 512, 2))
        total += 512
    srv.commit()
    assert len(srv.head_index) == total
    assert srv.stats["recoveries"] >= 1
    assert int(srv.head_index.dropped) == 0
    d2, nbrs, ok = srv.snapshot().knn(gen.uniform(2, 4, 2), 5)
    assert bool(ok.all())


def test_routing_drop_is_replayed_at_commit(mesh):
    sw = gen.sweepline(0, 4096, 2)
    srv = SpatialServer.build("spac-h", sw, mesh=mesh, phi=8, window=4,
                              slack=8.0)
    srv.head_index.slack = 0.25     # dispatch at a slab that overflows
    srv.insert(sw[:512])
    assert int(srv.head_index.dropped) > 0
    srv.commit()
    assert srv.stats["recoveries"] == 1
    assert len(srv.head_index) == 4096 + 512
    base = int(srv.head_index.dropped)
    srv.insert(gen.uniform(1, 64, 2))  # clean against the new baseline
    srv.commit()
    assert srv.stats["recoveries"] == 1
    assert int(srv.head_index.dropped) == base


def test_warm_rounds_build_no_plan(mesh):
    pts = gen.uniform(0, 2048, 2)
    srv = SpatialServer.build("spac-h", pts, mesh=mesh, phi=8, window=3)
    qs = gen.uniform(2, 16, 2)
    lo, hi = gen.query_boxes(3, 8, 2, gen.DEFAULT_HI // 8)
    bat = MicroBatcher(max_batch=1024, max_delay_s=60.0)

    def round_(r):
        bat.target = srv.snapshot()
        tks = [bat.submit_knn(qs[i], 5) for i in range(16)]
        tks += [bat.submit_range_count(lo[i], hi[i]) for i in range(8)]
        batch = gen.uniform(100 + r, 128, 2)
        srv.insert(batch)
        srv.delete(batch)
        for t in tks:
            t.result()
        srv.commit()

    round_(0)   # warm: plans and pow2 bucket escalations happen here
    engine.reset_trace_count()
    for r in range(1, 4):
        round_(r)
    assert engine.trace_count() == 0


def test_memory_accounting_sums_the_lanes(mesh):
    srv = SpatialServer.build("porth", gen.uniform(0, 1024, 2), mesh=mesh,
                              phi=8, window=2)
    head = srv.head_index
    lanes = sum(obs.tree_bytes(t) for t in head.tree)
    assert srv.memory_report()["live_bytes"] == lanes > 0
    assert head.nbytes == lanes + head.index.splitters.nbytes + \
        head.index.dropped.nbytes


def test_driver_mesh_payload_and_gauges(mesh, tmp_path):
    path = tmp_path / "smoke.json"
    driver.main(["--mesh", "2", "--device", "cpu", "--smoke", "--json",
                 str(path)])
    payload = json.loads(path.read_text())
    assert payload["config"]["mesh"] == 2
    for r in payload["results"]["spac-h"].values():
        d = r["distributed"]
        assert d["n_shards"] == 2 and d["dropped"] == 0
        assert sum(d["shard_points"]) == r["final_size"]
        assert d["shard_min_points"] == min(d["shard_points"])
    cfg = driver.DriverCfg(n=600, batch=64, steps=2, warmup=1, queries=8,
                           k=3, mesh=LANES)
    details = {}
    with obs.recording(obs.Recorder()) as rec:
        out = driver.run_one("porth", "sliding-window", cfg, mesh=mesh,
                             details=details)
    sizes = out["distributed"]["shard_points"]
    assert len(sizes) == LANES and sum(sizes) == out["final_size"] == \
        details["expected_size"]
    for i, n_live in enumerate(sizes):
        assert rec.gauges[f"server.shard{i}.live_points"]["value"] == n_live
    assert details["recoveries_by_step"] == [0] * 3
    # small shards (R*C <= 2^15) take the flat route
    assert rec.counters["engine.route.flat"] > 0


def test_dist_gate_suite_matches_the_committed_baseline():
    metrics = regress.SUITES["dist"](False, "cpu")
    root = pathlib.Path(__file__).resolve().parents[1]
    with open(root / regress.DEFAULT_BASELINE) as f:
        base = json.load(f)["metrics"]
    want = {k: v for k, v in base.items() if k.startswith("dist.")}
    assert metrics == want
    assert {m["kind"] for m in metrics.values()} == {"struct"}
    np.testing.assert_array_equal(
        sorted(k.split(".")[1] for k in metrics if k.endswith("final_size")),
        sorted(gen.SCENARIOS))
