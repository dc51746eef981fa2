"""The port's workload driver and instrumented serving stack against the
reference's: the same numpy arrays through both packages'
``SpatialServer`` + ``MicroBatcher`` give equal obs counters and span
counts, ``run_one`` gives the reference's result schema and sizes, the
CLI smoke exports a trace the viewer reads, and the entry points refuse
``--attributed`` with ``--mesh`` (as the reference's) and a missing
card."""

from __future__ import annotations

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import engine as jengine
from repro.serving import MicroBatcher as JBatcher
from repro.serving import SpatialServer as JServer
from repro.serving import driver as jdriver
from repro_torch import obs
from repro_torch.core import engine
from repro_torch.data import points as gen
from repro_torch.obs.memory import tree_bytes
from repro_torch.serving import MicroBatcher, SpatialServer
from repro_torch.serving import driver

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]

PHI = 8
N, BATCH, STEPS, Q, K = 5000, 256, 3, 16, 4
HI = 1 << 20
_rng = np.random.default_rng(0)
PTS = _rng.integers(0, HI, size=(N + STEPS * BATCH, 2)).astype(np.int32)
QPTS = _rng.integers(0, HI, size=(STEPS, Q, 2)).astype(np.int32)
# boxes of a quarter of the domain: at 5000 points the first range
# batch escalates its row buffer past the engine's starting 128 rows
LO = _rng.integers(0, HI // 2, size=(STEPS, Q, 2)).astype(np.int32)
BOX_HI = LO + np.int32(HI // 2)
# (kind, bootstrap points): at 5000 points R*C is past the flat budget
# (kNN takes the frontier route), at 1000 it is not (the flat route)
CASES = (("spac-h", N), ("porth", N), ("spac-h", 1000))

PARITY_COUNTERS = ("engine.plan_request", "engine.plan_miss",
                   "engine.escalation", "batcher.requests",
                   "server.mem.evictions")


def _clear_plan_caches():
    for fn in (jengine._knn_closure, jengine._range_count_closure,
               jengine._range_list_closure, engine._plan_signature,
               engine._knn_plan, engine._range_count_plan,
               engine._range_list_plan):
        fn.cache_clear()


def _serve(server_cls, batcher_cls, kind, n, device_kw):
    """Build on the first ``n`` points, then STEPS sliding-window steps
    of delete, insert, single-request kNN and range counts, commit."""
    srv = server_cls.build(kind, PTS[:n], phi=PHI, window=2,
                           capacity_points=n, **device_kw)
    batcher = batcher_cls(max_batch=Q, max_delay_s=1e9)
    answers = []
    for s in range(STEPS):
        batcher.target = srv.snapshot()
        srv.delete(PTS[s * BATCH: (s + 1) * BATCH])
        srv.insert(PTS[n + s * BATCH: n + (s + 1) * BATCH])
        knn = [batcher.submit_knn(QPTS[s, i], K) for i in range(Q)]
        cnt = [batcher.submit_range_count(LO[s, i], BOX_HI[s, i])
               for i in range(Q)]
        answers.append(([np.asarray(t.result()[0]) for t in knn],
                        [np.asarray(t.result()) for t in cnt]))
        srv.commit()
    return srv, answers


def _span_counts(rec) -> dict:
    out: dict[str, int] = {}
    for ev in rec.events:
        if ev["name"].startswith(("serving.", "batcher.")):
            out[ev["name"]] = out.get(ev["name"], 0) + 1
    return out


def _hist(rec, name) -> dict:
    return rec.hists[name].to_dict()


@pytest.mark.parametrize("kind,n", CASES)
def test_counters_match_the_reference(kind, n):
    _clear_plan_caches()
    with jobs.recording() as jrec:
        _, jans = _serve(JServer, JBatcher, kind, n, {})
    with obs.recording() as rec:
        srv, ans = _serve(SpatialServer, MicroBatcher, kind, n,
                          {"device": "cpu"})
    # range counts are exact integers in both (kNN answers are held to
    # the reference in the engine's and the kernels' own tests)
    for (_, jc), (_, c) in zip(jans, ans):
        np.testing.assert_array_equal(np.concatenate(c), np.concatenate(jc))
    for name in PARITY_COUNTERS:
        assert rec.counters.get(name, 0) == jrec.counters.get(name, 0), name
    for prefix in ("engine.route.", "batcher.flush."):
        got = {k: v for k, v in rec.counters.items() if k.startswith(prefix)}
        want = {k: v for k, v in jrec.counters.items()
                if k.startswith(prefix)}
        assert got == want and got, prefix
    assert rec.counters["server.mem.evictions"] == STEPS
    for name in ("batcher.coalesce_rows", "batcher.pad_rows",
                 "engine.escalation_rounds"):
        assert _hist(rec, name) == _hist(jrec, name), name
    assert _span_counts(rec) == _span_counts(jrec)
    assert _span_counts(rec)["serving.commit"] == STEPS
    assert rec.counters["engine.plan_miss"] >= 2   # knn + range_count
    assert rec.counters.get("engine.escalation", 0) >= (n == N)
    route = "flat" if n < N else "pallas-frontier"
    assert rec.counters[f"engine.route.{route}"] == STEPS
    # byte gauges are the port's own (int64 codes differ by design)
    live = rec.gauges["server.mem.live_bytes"]
    assert live["value"] == tree_bytes(srv.head_index.tree)
    assert rec.gauges["server.mem.window_bytes"]["value"] == live["value"]
    assert rec.counters["server.mem.evicted_bytes"] == \
        srv.mem["evicted_bytes"]


def _fixed_trace(scenario, *, seed=0, n, batch, steps, dim=2, **_):
    out = [gen.TraceStep(delete=PTS[s * batch: (s + 1) * batch],
                         insert=PTS[n + s * batch: n + (s + 1) * batch])
           for s in range(steps)]
    return gen._trace_of(PTS[:n], out)


def _fixed_queries(cfg, scenario, step):
    return QPTS[step], LO[step], BOX_HI[step]


CFG = dict(n=N, batch=BATCH, steps=2, warmup=1, queries=Q, k=K, phi=PHI)


def test_run_one_matches_the_reference(monkeypatch):
    """Both drivers replay the same arrays: the same result keys, final
    size, recoveries and evictions."""
    monkeypatch.setattr(jdriver.gen, "make_trace", _fixed_trace)
    monkeypatch.setattr(jdriver, "_query_stream", _fixed_queries)
    monkeypatch.setattr(driver.gen, "make_trace", _fixed_trace)
    monkeypatch.setattr(driver, "_query_stream", _fixed_queries)
    want = jdriver.run_one("spac-h", "sliding-window",
                           jdriver.DriverCfg(**CFG))
    details = {}
    got = driver.run_one("spac-h", "sliding-window", driver.DriverCfg(**CFG),
                         device="cpu", details=details)
    assert set(got) == set(want)
    for key in ("latency_ms", "throughput", "memory"):
        assert set(got[key]) == set(want[key]), key
    assert set(got["latency_ms"]["knn"]) == set(want["latency_ms"]["knn"])
    assert got["final_size"] == want["final_size"] == N
    assert got["recoveries"] == want["recoveries"] == 0
    assert got["memory"]["evictions"] == want["memory"]["evictions"]
    assert details["expected_size"] == N
    assert details["units"] == {"insert": 2 * BATCH, "delete": 2 * BATCH,
                                "knn": 2 * Q, "range": 2 * Q}


def test_trace_counter_equals_trace_count():
    cfg = driver.DriverCfg(n=800, batch=64, steps=1, warmup=1, queries=8,
                           k=3, phi=PHI)
    engine._knn_plan.cache_clear()
    engine._range_count_plan.cache_clear()
    with obs.recording() as rec:
        t0 = engine.trace_count()
        details = {}
        driver.run_one("porth", "uniform", cfg, device="cpu",
                       details=details)
        delta = engine.trace_count() - t0
    assert delta >= 2
    assert rec.counters["engine.trace"] == delta
    assert details["counters"]["engine.trace"] == delta
    assert sum(v for k, v in rec.counters.items()
               if k.startswith("engine.route.")) == cfg.warmup + cfg.steps


def test_cli_smoke_and_viewer(tmp_path):
    out, trace = tmp_path / "serve.json", tmp_path / "obs.json"
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "1"}
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.serving.driver", "--smoke",
         "--device", "cpu", "--json", str(out), "--obs-trace", str(trace)],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "serving driver smoke OK" in run.stdout
    view = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.view", str(trace),
         "--by-name"], capture_output=True, text=True, timeout=60, env=env,
        cwd=REPO)
    assert view.returncode == 0, view.stderr
    assert "serving.commit" in view.stdout


def test_mesh_and_missing_card_raise(monkeypatch):
    """``--attributed`` compares obs off and on on one device, so it
    refuses ``--mesh`` (as the reference's does); without a card the
    entry points raise (``--mesh`` runs: see
    ``tests/test_torch_serving_distributed.py``)."""
    with pytest.raises(AssertionError, match="drop --mesh"):
        driver.main(["--mesh", "2", "--device", "cpu", "--attributed",
                     "/nonexistent/serve_trace.json"])
    cfg = driver.DriverCfg(n=64, batch=8, steps=1, warmup=0, queries=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        driver.run_one("spac-h", "uniform", cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        driver.main(["--smoke"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        driver.main(["--smoke", "--mesh", "2"])
