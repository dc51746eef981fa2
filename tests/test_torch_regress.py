"""``repro_torch.obs.regress`` against ``repro.obs.regress``: the same
metrics, bands, comparison, rendering, injection and snapshot naming on
the same inputs; the CLI round trip (--update -> gate -> --replay) on a
fake suite; the port's payload validation under ``results/port/``; and
the ``dist`` suite's metric names."""

from __future__ import annotations

import json

import pytest

from repro.obs import regress as jregress
from repro_torch.obs import regress


def _metrics():
    return {
        "t.p50_ms": regress.metric(10.0),
        "t.qps": regress.metric(500.0, "higher"),
        "s.bytes": regress.metric(100_000, "lower", "struct"),
        "s.avg_out": regress.metric(0.2, "higher", "struct"),
    }


def _current():
    cur = _metrics()
    cur["t.p50_ms"]["value"] = 25.0
    cur["t.qps"]["value"] = 5_000.0
    cur["s.bytes"]["value"] = 130_000
    del cur["s.avg_out"]
    cur["extra"] = regress.metric(1.0)
    return cur


@pytest.mark.parametrize("case", [
    "metric", "worse_ratio", "compare", "compare-ci", "render", "inject",
    "snapshot-path", "constants"])
def test_logic_equals_the_reference(case, tmp_path):
    if case == "metric":
        for args in ((1.5,), (2, "higher"), (3, "lower", "struct")):
            assert regress.metric(*args) == jregress.metric(*args)
    elif case == "worse_ratio":
        for args in ((10.0, 25.0, "lower", 2.0), (500.0, 180.0, "higher",
                                                  2.0), (0.4, 1.9, "lower",
                                                         2.0),
                     (0.1, 0.0, "higher", 1.0)):
            assert regress._worse_ratio(*args) == jregress._worse_ratio(*args)
    elif case in ("compare", "compare-ci"):
        tol = 1.0 if case == "compare" else regress.CI_TIME_TOL
        assert regress.compare(_current(), _metrics(), tol, 0.25) == \
            jregress.compare(_current(), _metrics(), tol, 0.25)
    elif case == "render":
        rows, _ = regress.compare(_current(), _metrics(), 1.0, 0.25)
        assert regress.render(rows, 1.0, 0.25) == \
            jregress.render(rows, 1.0, 0.25)
    elif case == "inject":
        assert regress.inject(_metrics(), 2.0) == \
            jregress.inject(_metrics(), 2.0)
    elif case == "snapshot-path":
        assert regress.next_snapshot_path(str(tmp_path)) == \
            jregress.next_snapshot_path(str(tmp_path))
        for n in (1, 7, 3):
            (tmp_path / f"BENCH_{n}.json").write_text("{}")
        assert regress.next_snapshot_path(str(tmp_path)) == \
            jregress.next_snapshot_path(str(tmp_path)) == \
            str(tmp_path / "BENCH_8.json")
    else:
        for name in ("LOCAL_TIME_TOL", "CI_TIME_TOL", "STRUCT_TOL",
                     "TIME_FLOOR", "STRUCT_FLOOR"):
            assert getattr(regress, name) == getattr(jregress, name)


@pytest.fixture
def fake_suite(monkeypatch):
    state = {"runs": 0, "devices": []}

    def suite(verbose, device=None):
        state["runs"] += 1
        state["devices"].append(str(device))
        return _metrics()

    monkeypatch.setattr(regress, "SUITES", {"fake": suite})
    # the committed payloads are checked by their own test below
    monkeypatch.setattr(regress, "check_baselines", lambda root=None: [])
    return state


def test_cli_update_then_gate_then_replay(fake_suite, tmp_path, capsys):
    base = tmp_path / "base.json"
    snap = tmp_path / "snap.json"
    assert regress.main(["--suites", "fake", "--update", "--quiet",
                         "--baseline", str(base), "--device", "cpu"]) == 0
    assert json.loads(base.read_text())["metrics"]["t.p50_ms"][
        "value"] == 10.0
    assert fake_suite["runs"] == 1 and fake_suite["devices"] == ["cpu"]

    assert regress.main(["--suites", "fake", "--baseline", str(base),
                         "--snapshot", str(snap), "--quiet",
                         "--device", "cpu"]) == 0
    payload = json.loads(snap.read_text())
    assert payload["regressed"] == 0
    assert {r["status"] for r in payload["rows"]} == {"ok"}
    assert fake_suite["runs"] == 2

    # the replay re-compares without re-running suites; an injected 2x
    # regression fails the gate (the card's self-test shape)
    assert regress.main(["--replay", str(snap), "--baseline", str(base),
                         "--inject-scale", "2", "--tol", "0.5",
                         "--no-snapshot", "--quiet"]) == 1
    assert fake_suite["runs"] == 2
    out = capsys.readouterr().out
    assert "REGRESSED" in out and "FAIL" in out


def test_cli_errors(fake_suite, tmp_path):
    assert regress.main(["--suites", "nope", "--no-snapshot"]) == 2
    assert regress.main(["--suites", "fake", "--baseline",
                         str(tmp_path / "absent.json"), "--no-snapshot",
                         "--quiet", "--device", "cpu"]) == 2
    assert regress.main(["--replay", str(tmp_path / "absent.json"),
                         "--baseline", str(tmp_path / "absent.json"),
                         "--no-snapshot"]) == 2


def test_dist_suite_is_refused_with_its_queue_item(tmp_path):
    """The name is kept from when the suite was refused: the ``dist``
    suite is one of the defaults now and gates the reference's metric
    names (its values: ``tests/test_torch_serving_distributed.py``)."""
    assert list(regress.SUITES) == list(jregress.SUITES)
    base = tmp_path / "base.json"
    assert regress.main(["--suites", "dist", "--update", "--quiet",
                         "--baseline", str(base), "--device", "cpu"]) == 0
    names = set(json.loads(base.read_text())["metrics"])
    assert names == {f"dist.{scen}.{m}" for scen in (
        "uniform", "sweepline", "varden", "moving-objects", "sliding-window")
        for m in ("final_size", "shard_min_points", "shard_max_points")}


def _valid_payloads() -> dict:
    return {
        "serve_latency.json": {"results": {"spac-h": {"uniform": {
            "latency_ms": {}}}}},
        "fig3_grid.json": {"results": {"uniform/porth": {}},
                           "validate": [{"claim": "c"}]},
        "fig4_knn.json": {"qps": {"porth": {}}},
        "fig5_range.json": {"qps": {"porth": {}}},
        "fig9_3d.json": {"results": {"uniform/porth": {}}},
        "fig10_batch.json": {"update_pts_per_s": {"porth": {}}},
        "roofline.json": {"results": {"porth": {}}, "obs": {},
                          "block_sweep": {"chosen": {}}},
        "serve_trace.json": {"results": {"spac-h": {
            "knn_p50_ms": {}, "cost_model": {"plan_costs": {
                "knn.q64.k10.pallas-frontier-auto.v1x64": {}}}}}},
    }


def test_check_baselines_flags_missing_and_truncated_payloads(tmp_path):
    assert len(regress.check_baselines(str(tmp_path))) == \
        len(regress.BASELINE_SPECS)
    for name, payload in _valid_payloads().items():
        (tmp_path / name).write_text(json.dumps(payload))
    assert regress.check_baselines(str(tmp_path)) == []
    (tmp_path / "roofline.json").write_text(json.dumps(
        {"results": {"porth": {}}, "obs": {}}))
    (tmp_path / "fig4_knn.json").write_text("{")
    (tmp_path / "fig5_range.json").unlink()
    problems = regress.check_baselines(str(tmp_path))
    assert len(problems) == 3
    assert any("fig5_range.json: committed baseline missing" in p
               for p in problems)


def test_committed_payloads_validate():
    """The card's payloads under results/port/ parse and keep their
    shape (the roofline carries the tile sweep's chosen tile, the serve
    trace a captured frontier-kernel plan)."""
    assert regress.check_baselines() == []
