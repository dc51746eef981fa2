"""Serving-runtime contract tests for the port, mirroring
tests/test_serving.py: snapshot isolation, the bounded version window,
refusal of donation, deferred-overflow replay at ``commit()``, and
micro-batcher bit parity, admission and plan caching -- plus the port's
numpy traces and latency summaries."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import BACKENDS, engine, make_index
from repro_torch.data import points as gen
from repro_torch.serving import LatencyRecorder, MicroBatcher, SpatialServer
from repro_torch.serving.metrics import summarize

torch.set_num_threads(1)

PHI = 8
N, Q, K = 600, 12, 4
HI = 1 << 20

_rng = np.random.default_rng(0)
PTS = _rng.integers(0, HI, size=(N, 2)).astype(np.int32)
QS = _rng.integers(0, HI, size=(Q, 2)).astype(np.int32)
BATCH = _rng.integers(0, HI, size=(128, 2)).astype(np.int32)
BOX_LO = _rng.integers(0, HI // 2, size=(Q, 2)).astype(np.int32)
BOX_HI = BOX_LO + np.int32(HI // 3)


def _server(kind: str, **kw) -> SpatialServer:
    if kind.startswith(("spac", "cpam")):   # the spac family's code width
        kw["coord_bits"] = 20
    return SpatialServer.build(kind, PTS, phi=PHI, capacity_points=2 * N,
                               device="cpu", **kw)


@pytest.mark.parametrize("kind", sorted(BACKENDS))
def test_snapshot_isolation(kind):
    srv = _server(kind)
    snap = srv.snapshot()
    d2_a, ids_a = snap.knn(QS, K)
    cnt_a = snap.range_count(BOX_LO, BOX_HI)
    srv.insert(BATCH)
    srv.delete(PTS[:100])
    assert srv.in_flight == 2 and srv.head_version == snap.version + 2
    d2_b, ids_b = snap.knn(QS, K)
    assert torch.equal(d2_a, d2_b) and torch.equal(ids_a, ids_b)
    assert torch.equal(cnt_a, snap.range_count(BOX_LO, BOX_HI))
    assert srv.commit() == snap.version + 2
    assert len(srv.snapshot()) == N + BATCH.shape[0] - 100
    assert len(snap.index) == N
    assert srv.stats["update_points"] == BATCH.shape[0] + 100


def test_window_evicts_and_snapshot_of_evicted_version_raises():
    srv = _server("spac-h", window=2)
    v0 = srv.head_version
    for i in range(4):
        srv.insert(BATCH[i * 16: (i + 1) * 16])
    assert len(srv.versions) == 2 and srv.mem["evictions"] == 3
    with pytest.raises(KeyError):
        srv.snapshot(v0)
    srv.commit()
    assert srv.versions == (srv.head_version,)
    report = srv.memory_report()
    assert report["retained"] == 1
    assert report["live_bytes"] == srv.head_index.nbytes


def test_server_rejects_donation():
    idx = make_index("spac-h", PTS, phi=PHI, device="cpu", donate=True)
    with pytest.raises(ValueError, match="non-donating"):
        SpatialServer(idx)
    with pytest.raises(ValueError, match="donate"):
        SpatialServer.build("spac-h", PTS, device="cpu", donate=True)
    with pytest.raises(ValueError, match="window"):
        SpatialServer(make_index("spac-h", PTS, device="cpu"), window=0)


@pytest.mark.parametrize("window", [2, 8])
def test_commit_recovers_deferred_overflow(window):
    """Inserts past capacity set the sticky flag; the eviction check
    (window 2) or commit (window 8) replays from the last good version
    and the committed head holds the exact multiset."""
    idx = make_index("spac-h", PTS, phi=PHI, device="cpu", coord_bits=20)
    srv = SpatialServer(idx, window=window)
    rng = np.random.default_rng(3)
    total = N
    for _ in range(6):
        srv.insert(rng.integers(0, HI, size=(600, 2)).astype(np.int32))
        total += 600
    srv.delete(PTS[:50], mask=torch.ones(50, dtype=torch.bool))
    srv.commit()
    assert len(srv.head_index) == total - 50
    assert srv.stats["recoveries"] >= 1
    assert srv.stats["update_points"] == 6 * 600 + 50


@pytest.mark.parametrize("kind", ["spac-h", "cpam-z"])
def test_batcher_bit_parity(kind):
    idx = make_index(kind, PTS, phi=PHI, device="cpu")
    mb = MicroBatcher(idx, max_batch=1 << 30, max_delay_s=1e9)
    spans = [(0, 1), (1, 4), (4, 9), (9, Q)]
    knn_t = [mb.submit_knn(QS[a:b], K) for a, b in spans]
    rng_t = [mb.submit_range_count(BOX_LO[a:b], BOX_HI[a:b])
             for a, b in spans]
    lst_t = [mb.submit_range_list(BOX_LO[a:b], BOX_HI[a:b])
             for a, b in spans]
    tns_t = mb.submit_knn(torch.as_tensor(QS[:3]), K)   # tensor payload
    assert mb.pending == 3 * Q + 3
    assert mb.flush() == 4
    for (a, b), t in zip(spans, knn_t):
        d2, ids = idx.knn(QS[a:b], K)
        got_d2, got_ids = t.result()
        assert torch.equal(got_d2, d2) and torch.equal(got_ids, ids)
    for (a, b), t in zip(spans, rng_t):
        assert torch.equal(t.result(),
                           idx.range_count(BOX_LO[a:b], BOX_HI[a:b]))
    for (a, b), t in zip(spans, lst_t):
        got_ids, got_cnt = t.result()
        _, want_cnt = idx.range_list(BOX_LO[a:b], BOX_HI[a:b])
        assert torch.equal(got_cnt, want_cnt)
        assert ((got_ids >= 0).sum(-1) == want_cnt).all()
    assert torch.equal(tns_t.result()[0], idx.knn(QS[:3], K)[0])


def test_batcher_admission_knobs():
    idx = make_index("spac-h", PTS, phi=PHI, device="cpu")
    mb = MicroBatcher(idx, max_batch=4, max_delay_s=1e9)
    ts = [mb.submit_knn(QS[i], K) for i in range(4)]
    assert all(t.done for t in ts) and mb.flush_reasons == {"size": 1}
    mb0 = MicroBatcher(idx, max_batch=1 << 30, max_delay_s=0.0)
    assert mb0.submit_knn(QS[0], K).done
    clock = [0.0]
    mb1 = MicroBatcher(idx, max_batch=1 << 30, max_delay_s=1.0,
                       clock=lambda: clock[0])
    tk = mb1.submit_knn(QS[0], K)
    assert not tk.done and mb1.poll() == 0
    clock[0] = 2.0
    assert mb1.poll() == 1 and tk.done
    with pytest.raises(ValueError, match="target"):
        MicroBatcher(max_delay_s=0.0).submit_knn(QS[0], K)


def test_batcher_retarget_drains_and_snapshot_provider():
    srv = _server("spac-h")
    mb = MicroBatcher(srv.snapshot(), max_batch=1 << 30, max_delay_s=1e9)
    everything = (np.zeros((1, 2), np.int32), np.full((1, 2), HI - 1,
                                                      np.int32))
    t = mb.submit_range_count(*everything)
    srv.insert(BATCH)
    srv.commit()
    mb.target = srv.snapshot()             # drains against the old snap
    assert t.done and int(t.result()[0]) == N
    provider = MicroBatcher(srv.snapshot, max_batch=1 << 30,
                            max_delay_s=1e9)
    t1 = provider.submit_range_count(*everything)
    srv.insert(BATCH)
    srv.commit()
    assert int(t1.result()[0]) == N + 2 * BATCH.shape[0]


def test_batcher_pow2_padding_hits_cached_plans():
    idx = make_index("spac-h", PTS, phi=PHI, device="cpu")
    mb = MicroBatcher(idx, max_batch=1 << 30, max_delay_s=1e9)
    sizes = [1, 2, 3, 5, 7, 9, 12]
    buckets = {1 << max(s - 1, 0).bit_length() for s in sizes}
    engine._knn_plan.cache_clear()
    engine.reset_trace_count()
    for _ in range(2):
        for s in sizes:
            mb.submit_knn(QS[:s], K)
            mb.flush()
    assert engine.trace_count() == len(buckets)


@pytest.mark.parametrize("scenario", gen.SCENARIOS)
def test_traces_deterministic_and_sized(scenario):
    a = gen.make_trace(scenario, seed=4, n=300, batch=32, steps=3)
    b = gen.make_trace(scenario, seed=4, n=300, batch=32, steps=3)
    assert a.max_live == b.max_live and a.final_size == b.final_size
    np.testing.assert_array_equal(a.bootstrap, b.bootstrap)
    for sa, sb in zip(a.steps, b.steps):
        np.testing.assert_array_equal(sa.insert, sb.insert)
        np.testing.assert_array_equal(sa.delete, sb.delete)
        assert sa.insert.dtype == np.int32
        assert (sa.insert >= 0).all() and (sa.insert < gen.DEFAULT_HI).all()
    idx = make_index("spac-h", a.bootstrap, phi=PHI, device="cpu",
                     capacity_points=a.max_live, coord_bits=20)
    for step in a.steps:
        idx = idx.delete(step.delete).insert(step.insert)
    assert len(idx) == a.final_size


def test_query_boxes_and_unknown_scenario():
    lo, hi = gen.query_boxes(1, 50, 2, 1024)
    ext = hi - lo
    assert ((ext >= 512) & (ext <= 1024)).all() and (lo >= 0).all()
    with pytest.raises(KeyError, match="unknown scenario"):
        gen.make_trace("zipf", n=10, batch=2, steps=1)


def test_latency_recorder():
    clock = [0.0]
    rec = LatencyRecorder(clock=lambda: clock[0])
    for ms in (1.0, 2.0, 3.0, 4.0):
        with rec.timer("knn", units=10):
            clock[0] += ms / 1e3
    s = rec.latency_summary()["knn"]
    assert s["count"] == 4 and s["min_ms"] == pytest.approx(1.0)
    assert s["p50_ms"] == pytest.approx(2.5)
    assert rec.throughput(["knn"])["knn"] == pytest.approx(40 / 0.01)
    assert rec.samples("knn") == pytest.approx([1e-3, 2e-3, 3e-3, 4e-3])
    assert summarize([]) == {"count": 0}
    rec.reset()
    assert rec.latency_summary() == {} and rec.count("knn") == 0
