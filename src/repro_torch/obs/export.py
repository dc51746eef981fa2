"""Exporters: JSON-lines and Chrome trace-event format.

Counterpart of ``repro/obs/export.py`` with the same record and event
schema, so each package's viewer reads the other's files. Two on-disk
shapes, both derived from :meth:`Recorder.report` /
``Recorder.events`` (so exporting resolves deferred device reads — it
is a report barrier):

* **JSONL** (:func:`write_jsonl`): one object per line — a ``meta``
  line, then every span in timeline order, then ``counter`` /
  ``gauge`` / ``hist`` lines. Grep- and pandas-friendly.
* **Chrome trace events** (:func:`write_chrome_trace`): the
  ``{"traceEvents": [...]}`` JSON that chrome://tracing and Perfetto
  (https://ui.perfetto.dev) load directly. Spans become complete
  ("ph": "X") events with microsecond timestamps; counters, gauges and
  histogram summaries ride in ``otherData`` so the summary CLI
  (:mod:`repro_torch.obs.view`) can reconstruct the full report from the
  trace file alone.
"""

from __future__ import annotations

import json
import os

from .record import Recorder

TRACE_VERSION = 1


def _ensure_dir(path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)


def jsonl_records(rec: Recorder) -> list[dict]:
    report = rec.report()                     # resolves deferred reads
    out: list[dict] = [{"type": "meta", "version": TRACE_VERSION,
                        "wall_s": report["wall_s"]}]
    for ev in rec.events:
        out.append({"type": "span", **ev})
    for name, value in report["counters"].items():
        out.append({"type": "counter", "name": name, "value": value})
    for name, g in report["gauges"].items():
        out.append({"type": "gauge", "name": name, **g})
    for name, h in report["hists"].items():
        out.append({"type": "hist", "name": name, **h})
    return out


def write_jsonl(rec: Recorder, path: str) -> str:
    _ensure_dir(path)
    with open(path, "w") as f:
        for record in jsonl_records(rec):
            f.write(json.dumps(record, sort_keys=True) + "\n")
    return path


def chrome_trace(rec: Recorder, pid: int = 1, tid: int = 1) -> dict:
    report = rec.report()                     # resolves deferred reads
    events = []
    for ev in rec.events:
        out = {"name": ev["name"], "ph": "X", "pid": pid, "tid": tid,
               "ts": ev["ts"] * 1e6, "dur": ev["dur"] * 1e6,
               "cat": ev.get("cat", "obs")}
        if "args" in ev:
            out["args"] = ev["args"]
        events.append(out)
    # counters as Chrome counter ("C") samples at end-of-run so the
    # totals are visible on the timeline too
    t_end = report["wall_s"] * 1e6
    for name, value in report["counters"].items():
        events.append({"name": name, "ph": "C", "pid": pid, "ts": t_end,
                       "args": {"value": value}})
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"version": TRACE_VERSION,
                      "wall_s": report["wall_s"],
                      "counters": report["counters"],
                      "gauges": report["gauges"],
                      "hists": report["hists"],
                      "spans": report["spans"]},
    }


def write_chrome_trace(rec: Recorder, path: str) -> str:
    _ensure_dir(path)
    with open(path, "w") as f:
        json.dump(chrome_trace(rec), f, indent=1, sort_keys=True)
    return path
