"""``repro_torch.obs.costs`` against ``repro.obs.costs``: under
``Recorder(capture_costs=True)`` the port's engine and index capture the
same plan signatures as the reference's on the same arrays, each once;
``plan_costs`` groups the counters; the workload driver's
``--attributed`` cost section is filled from them."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import make_index as jmake_index
from repro_torch import obs
from repro_torch.core import make_index
from repro_torch.serving import driver

torch.set_num_threads(1)

N, Q = 700, 16


def _arrays():
    rng = np.random.default_rng(4)
    pts = rng.integers(0, 1 << 10, size=(N, 2)).astype(np.int32)
    new = rng.integers(0, 1 << 10, size=(96, 2)).astype(np.int32)
    qs = rng.integers(0, 1 << 10, size=(Q, 2)).astype(np.int32)
    lo = rng.integers(0, 800, size=(Q, 2)).astype(np.int32)
    return pts, new, qs, lo, lo + 200


def _sequence(make, kind: str, impls, params: dict):
    pts, new, qs, lo, hi = _arrays()
    idx = make(kind, pts, phi=8, **params)
    idx = idx.insert(new)
    idx = idx.insert(new)          # the same plan again: no new capture
    idx = idx.delete(pts[:50])
    for impl in impls:
        idx.knn(qs, 5, impl=impl)
        idx.knn(qs, 5, impl=impl)
    idx.range_count(lo, hi)
    idx.range_list(lo, hi)


@pytest.mark.parametrize("kind,params", [
    ("spac-h", {"coord_bits": 20}), ("porth", {}), ("zd", {})])
def test_same_signatures_as_the_reference_each_once(kind, params):
    with jobs.recording(jobs.Recorder(capture_costs=True)) as jrec:
        _sequence(jmake_index, kind, ("auto", "frontier", "flat",
                                      "pallas-frontier"), params)
    with obs.recording(obs.Recorder(capture_costs=True)) as rec:
        _sequence(lambda *a, **kw: make_index(*a, device="cpu", **kw), kind,
                  ("auto", "frontier", "cuda", "cuda-frontier"), params)
    want = set(jobs.costs.plan_costs(jrec.counters))
    got = obs.costs.plan_costs(rec.counters)
    assert set(got) == want
    assert any(s.startswith("update.") for s in want)
    assert {s.split(".")[0] for s in want} >= {"knn", "range_count",
                                                "range_list", "update"}
    # once per signature, in both packages
    assert rec.counters["plan.cost.captured"] == len(got) == \
        jrec.counters["plan.cost.captured"]
    for sig, cost in got.items():
        assert set(cost) == {"device_us", "launches"}
        assert cost["device_us"] > 0 and cost["launches"] > 0
        assert rec.cost_kernels[sig]
    assert set(rec.report()["plan_kernels"]) == set(got)


def test_plan_costs_groups_the_counters():
    counters = {"plan.cost.knn.q64.k10.flat-auto.v4x64.device_us": 12.5,
                "plan.cost.knn.q64.k10.flat-auto.v4x64.launches": 3,
                "plan.cost.update.porth.insert.m8.d2.r4.device_us": 2.0,
                "plan.cost.captured": 2,
                "plan.cost.knn.q64.k10.flat-auto.v4x64.flops": 9,
                "engine.plan_miss": 4}
    assert obs.costs.plan_costs(counters) == {
        "knn.q64.k10.flat-auto.v4x64": {"device_us": 12.5, "launches": 3},
        "update.porth.insert.m8.d2.r4": {"device_us": 2.0}}


def test_capture_is_off_without_a_capturing_recorder():
    calls = []
    assert not obs.costs.enabled()
    assert not obs.costs.capture(lambda: calls.append(1), (), "x")
    with obs.recording(obs.Recorder()):
        assert not obs.costs.capture(lambda: calls.append(1), (), "x")
    assert calls == []


def test_attributed_cost_section_is_filled():
    cfg = driver.DriverCfg(n=1500, batch=128, steps=2, warmup=1,
                           queries=16, k=5)
    payload = driver.run_attributed(kinds=("spac-h",), scenario="uniform",
                                    cfg=cfg, verbose=False, device="cpu")
    cm = payload["results"]["spac-h"]["cost_model"]
    assert cm["plan_costs"]
    assert cm["knn_plan_sig"].startswith("knn.q")
    assert cm["knn_plan_sig"] in cm["plan_costs"]
    assert cm["knn_expected_device_ms"] == \
        cm["plan_costs"][cm["knn_plan_sig"]]["device_us"] / 1e3 > 0
    assert cm["knn_plan_launches"] > 0 and cm["knn_plan_kernels"]
    assert cm["knn_device_wait_observed_ms"] >= 0
    assert any(s.startswith("update.spac-h.") for s in cm["plan_costs"])
