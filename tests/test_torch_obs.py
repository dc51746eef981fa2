"""``repro_torch.obs`` against ``repro.obs``: the same inputs give the
same buckets, percentiles, latency summaries and exported files; each
viewer reads the other's files; disabled mode records nothing; device
values are read only in ``Recorder.resolve`` (checked by running it and
by the reference's ``obs-deferred-sync`` rule pointed at the port)."""

from __future__ import annotations

import ast
import json
import pathlib
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.analysis.rules import ObsDeferredSync
from repro.analysis.visitor import JitRegistry, LintContext, ModuleInfo
from repro.obs import view as jview
from repro.serving.metrics import LatencyRecorder as JLatencyRecorder
from repro_torch import obs
from repro_torch.obs import view
from repro_torch.serving.metrics import LatencyRecorder

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
OBS_SOURCES = sorted((REPO / "src" / "repro_torch" / "obs").glob("*.py"))
_rng = np.random.default_rng(0)
SAMPLES = np.concatenate([_rng.lognormal(-5.0, 1.5, 300), [0.0, 1.0, 0.5]])


def test_pow2_bucket_matches_the_reference():
    values = [0, -1, 0.25, 0.3, 0.5, 1, 3, 4, 5, 1e-9, 2.0 ** 40, 7.5]
    values += list(SAMPLES)
    assert [obs.pow2_bucket(v) for v in values] == \
        [jobs.pow2_bucket(v) for v in values]


@pytest.mark.parametrize("max_samples", [8192, 64])
def test_hist_summary_matches_the_reference(max_samples):
    """Under retention (exact percentiles) and past it (bucket edges)."""
    h, jh = obs.Hist(max_samples), jobs.Hist(max_samples)
    for v in SAMPLES:
        h.observe(v)
        jh.observe(v)
    assert bool(h.dropped) == (max_samples < len(SAMPLES))
    assert h.summary() == jh.summary()
    assert h.summary(scale=1e3) == jh.summary(scale=1e3)
    assert h.to_dict() == jh.to_dict()


def test_latency_summary_past_retention_matches_the_reference():
    """10,000 samples: past the 8,192-sample retention both report pow2
    bucket edges (the port once took numpy percentiles of every sample,
    which differ)."""
    samples = _rng.lognormal(-4.0, 1.0, 10_000)
    rec, jrec = LatencyRecorder(), JLatencyRecorder()
    for s in samples:
        rec.record("knn", s)
        jrec.record("knn", s)
    got, want = rec.latency_summary(), jrec.latency_summary()
    assert got == want
    assert got["knn"]["count"] == 10_000
    assert got["knn"]["p50_ms"] != pytest.approx(
        float(np.percentile(samples, 50)) * 1e3, rel=1e-3)


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.00125
        return self.t


def _script(pkg, scalar, vector, tmp: pathlib.Path) -> dict:
    """One recording session through ``pkg``'s Recorder; returns the
    files both exporters wrote, parsed."""
    rec = pkg.Recorder(clock=_Clock(), max_samples=4)
    with pkg.recording(rec):
        with pkg.span("serving.insert", rows=128, version=1) as sp:
            sp.defer("size", scalar)
            sp.defer("shape", vector)
        sp2 = pkg.span("serving.commit", "barrier").begin()
        sp2.set(version=2)
        sp2.end()
        pkg.count("engine.plan_request")
        pkg.count("engine.plan_request", 2)
        pkg.count("server.mem.evicted_bytes", 4096)
        pkg.gauge("batcher.queue_depth", 3)
        pkg.gauge("batcher.queue_depth", 1)
        for v in (1, 2, 3, 5, 8, 13):
            pkg.observe("batcher.coalesce_rows", v)
        rec.add_span("lat.knn", rec.clock(), 0.004, cat="latency", units=64)
        pkg.defer("index.size", scalar)
        assert pkg.resolve() == 3
    jsonl = pkg.write_jsonl(rec, str(tmp / "trace.jsonl"))
    chrome = pkg.write_chrome_trace(rec, str(tmp / "trace.json"))
    return {"jsonl": [json.loads(line) for line in open(jsonl)],
            "chrome": json.load(open(chrome))}


def test_exports_match_the_reference(tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    want = _script(jobs, jnp.asarray(7, jnp.int32), jnp.arange(3),
                   tmp_path / "ref")
    got = _script(obs, torch.tensor(7, dtype=torch.int32), torch.arange(3),
                  tmp_path / "port")
    assert got == want
    spans = [r for r in got["jsonl"] if r["type"] == "span"]
    assert spans[0]["args"]["size"] == 7.0
    assert spans[0]["args"]["shape"] is True
    counters = {r["name"]: r["value"] for r in got["jsonl"]
                if r["type"] == "counter"}
    assert counters["index.size"] == 7.0


def test_each_viewer_reads_the_other_packages_files(tmp_path, capsys):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    _script(jobs, jnp.asarray(1), jnp.arange(2), tmp_path / "ref")
    _script(obs, torch.tensor(1), torch.arange(2), tmp_path / "port")
    for name in ("trace.json", "trace.jsonl"):
        for flags in ([], ["--by-name"]):
            outs = []
            for src in ("ref", "port"):
                for viewer in (view, jview):
                    path = str(tmp_path / src / name)
                    assert viewer.main([path, *flags]) == 0
                    outs.append(capsys.readouterr().out)
            assert len(set(outs)) == 1, (name, flags)
            assert "serving.insert" in outs[0]
    bad = tmp_path / "bad.json"
    for text in ("", "{not json", '{"traceEvents": []}', "[1, 2]",
                 '{"type": "nope"}\n'):
        bad.write_text(text)
        assert view.main([str(bad)]) == 1
        assert jview.main([str(bad)]) == 1
        assert "repro_torch.obs.view" in capsys.readouterr().err


def test_disabled_mode_records_nothing():
    assert not obs.enabled() and obs.recorder() is None
    assert obs.span("serving.insert", rows=1) is obs.NULL_SPAN
    with obs.span("x") as sp:
        assert sp.set(a=1).defer("b", torch.ones(1)) is obs.NULL_SPAN
    obs.count("c")
    obs.gauge("g", 1)
    obs.observe("h", 1.0)
    obs.defer("d", torch.ones(()))
    assert obs.resolve() == 0
    rec = obs.Recorder()
    with obs.recording(rec):
        assert obs.enabled() and obs.recorder() is rec
    assert not obs.enabled()
    assert not (rec.events or rec.counters or rec.gauges or rec.hists
                or rec.pending)


def test_concurrent_increments_are_exact():
    rec = obs.Recorder()
    per, threads = 5000, 8

    def work():
        for _ in range(per):
            rec.count("batcher.requests")
            rec.observe("batcher.wait_s", 0.5)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)     # switch threads as often as possible
    try:
        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    assert rec.counters["batcher.requests"] == per * threads
    assert rec.hists["batcher.wait_s"].count == per * threads


def test_deferred_tensors_are_read_only_in_resolve(monkeypatch):
    inside = [False]
    resolve = obs.Recorder.resolve

    def guarded_resolve(self):
        inside[0] = True
        try:
            return resolve(self)
        finally:
            inside[0] = False
    monkeypatch.setattr(obs.Recorder, "resolve", guarded_resolve)
    for name in ("item", "tolist", "cpu"):
        orig = getattr(torch.Tensor, name)

        def read(self, *a, _orig=orig, _name=name, **kw):
            if not inside[0]:
                raise AssertionError(f"Tensor.{_name} outside resolve")
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, read)
    rec = obs.Recorder(memory_snapshots=True)
    with obs.recording(rec):
        with obs.span("serving.insert") as sp:
            sp.defer("rows", torch.tensor(5))
            sp.defer("mask", torch.tensor([True, False]))
        obs.defer("index.size", torch.tensor(11))
        obs.count("engine.plan_request")
        assert rec.pending == 3
        assert obs.resolve() == 3
    assert rec.counters["index.size"] == 11.0
    assert rec.events[0]["args"]["rows"] == 5.0
    assert rec.events[0]["args"]["mask"] is True
    assert rec.report()["counters"]["engine.plan_request"] == 1


def test_capture_costs_raises():
    with pytest.raises(NotImplementedError, match="queue 1, item 2"):
        obs.Recorder(capture_costs=True)


class PortObsDeferredSync(ObsDeferredSync):
    """The reference's rule, pointed at the port's obs package (its own
    ``PACKAGE`` matches ``repro/obs/`` only)."""
    PACKAGE = "repro_torch/obs/"


def _rule_diagnostics(sources: dict) -> list:
    mods = [ModuleInfo.parse(path, text) for path, text in sources.items()]
    ctx = LintContext(modules=mods, jit_registry=JitRegistry())
    rule = PortObsDeferredSync()
    return [d for m in mods for d in rule.check(m, ctx)]


def test_obs_deferred_sync_rule_covers_the_port():
    assert len(OBS_SOURCES) == 5
    diags = _rule_diagnostics({str(p): p.read_text() for p in OBS_SOURCES})
    assert not diags, [d.render() for d in diags]
    planted = ("import torch\n\ndef peek(x):\n    return x.item()\n\n"
               "def mem():\n    return torch.cuda.memory_stats(0)\n")
    got = _rule_diagnostics({"src/repro_torch/obs/planted.py": planted})
    assert len(got) == 2
    # the reference's own PACKAGE does not see the port (the gap closed)
    mods = [ModuleInfo.parse("src/repro_torch/obs/planted.py", planted)]
    ctx = LintContext(modules=mods, jit_registry=JitRegistry())
    assert not list(ObsDeferredSync().check(mods[0], ctx))


def _reads_outside_resolve(tree: ast.AST) -> list:
    """Calls of ``.cpu()``, ``.tolist()``, ``.item()``,
    ``torch.cuda.synchronize`` or ``memory_stats`` outside a function
    named ``resolve``."""
    out = []
    stack = list(ast.iter_child_nodes(tree))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name == "resolve":
            continue
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and node.func.attr in (
                    "cpu", "tolist", "item", "synchronize", "memory_stats"):
            out.append((node.lineno, node.func.attr))
        stack.extend(ast.iter_child_nodes(node))
    return out


@pytest.mark.parametrize("path", OBS_SOURCES, ids=lambda p: p.name)
def test_no_device_reads_outside_resolve(path):
    assert not _reads_outside_resolve(ast.parse(path.read_text()))


def test_resolve_is_where_the_reads_are():
    tree = ast.parse((REPO / "src/repro_torch/obs/record.py").read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
              and n.name == "resolve")
    calls = {n.func.attr for n in ast.walk(fn) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Attribute)}
    assert {"item", "tolist", "memory_stats"} <= calls
    module = ast.Module(body=[fn], type_ignores=[])
    assert _reads_outside_resolve(ast.Module(
        body=[ast.FunctionDef(name="f", args=fn.args, body=fn.body,
                              decorator_list=[], returns=None,
                              type_params=[])], type_ignores=[]))
    assert not _reads_outside_resolve(module)
