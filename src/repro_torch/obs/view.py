"""Trace summary CLI: render an exported obs trace as tables.

Counterpart of ``repro/obs/view.py``; it reads either package's files.
Loads either exporter format (Chrome trace-event JSON or JSONL — the
format is sniffed, not flagged) and prints per-span latency stats,
counters, gauges and histogram summaries. Exit status 0 iff the file
parses as an obs trace; CI uses that as the "exported trace is
well-formed" check.

``--by-name`` collapses the raw timeline events to one row per span
name (count / total / mean, sorted by total) — the flat event dump of
a long driver trace is unreadable, the aggregation is what you scan
first. ``--top N`` limits both it and the default span table.

Run::

    PYTHONPATH=src python -m repro_torch.obs.view results/port/serve_trace.json
    PYTHONPATH=src python -m repro_torch.obs.view trace.jsonl --by-name --top 20
"""

from __future__ import annotations

import argparse
import json
import sys


def load(path: str) -> dict:
    """Normalize either exporter format to one report dict with keys
    counters/gauges/hists/spans/events (+ wall_s); ``events`` are the
    raw timeline spans as ``{name, cat, dur_ms}``. Raises ValueError
    for anything that is not an obs trace."""
    with open(path) as f:
        text = f.read()
    if not text.strip():
        raise ValueError(f"{path}: empty file")
    try:
        payload = json.loads(text)
    except json.JSONDecodeError:
        return _from_jsonl(path, text)
    if isinstance(payload, dict) and "traceEvents" in payload:
        other = payload.get("otherData", {})
        for key in ("counters", "hists", "spans"):
            if key not in other:
                raise ValueError(
                    f"{path}: chrome trace without obs otherData.{key}")
        # chrome "X" events carry microsecond durations
        other = dict(other)
        other["events"] = [
            {"name": ev["name"], "cat": ev.get("cat", ""),
             "dur_ms": ev.get("dur", 0.0) / 1e3}
            for ev in payload["traceEvents"] if ev.get("ph") == "X"]
        return other
    raise ValueError(f"{path}: not an obs trace (expected a chrome "
                     f"trace-event object or obs JSONL)")


def _from_jsonl(path: str, text: str) -> dict:
    counters: dict[str, float] = {}
    gauges: dict[str, dict] = {}
    hists: dict[str, dict] = {}
    durs: dict[str, list[float]] = {}
    events: list[dict] = []
    meta: dict = {}
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
            kind = rec.pop("type")
        except (json.JSONDecodeError, KeyError) as exc:
            raise ValueError(f"{path}:{i}: bad obs JSONL record "
                             f"({exc})") from None
        if kind == "meta":
            meta = rec
        elif kind == "span":
            durs.setdefault(rec["name"], []).append(rec["dur"])
            events.append({"name": rec["name"],
                           "cat": rec.get("cat", ""),
                           "dur_ms": rec["dur"] * 1e3})
        elif kind == "counter":
            counters[rec["name"]] = rec["value"]
        elif kind == "gauge":
            gauges[rec.pop("name")] = rec
        elif kind == "hist":
            hists[rec.pop("name")] = rec
        else:
            raise ValueError(f"{path}:{i}: unknown record type {kind!r}")
    spans = {}
    for name, ds in sorted(durs.items()):
        ds.sort()
        n = len(ds)
        spans[name] = {
            "count": n, "total_ms": sum(ds) * 1e3,
            "mean": sum(ds) / n * 1e3,
            "p50": ds[n // 2] * 1e3,
            "p95": ds[min(n - 1, int(0.95 * n))] * 1e3,
            "p99": ds[min(n - 1, int(0.99 * n))] * 1e3,
            "min": ds[0] * 1e3, "max": ds[-1] * 1e3,
        }
    return {"wall_s": meta.get("wall_s"), "counters": counters,
            "gauges": gauges, "hists": hists, "spans": spans,
            "events": events}


def by_name(events: list) -> dict:
    """Collapse raw timeline events to per-name totals:
    ``{name: {cat, count, total_ms, mean_ms}}``."""
    agg: dict[str, dict] = {}
    for ev in events:
        a = agg.get(ev["name"])
        if a is None:
            a = agg[ev["name"]] = {"cat": ev.get("cat", ""),
                                   "count": 0, "total_ms": 0.0}
        a["count"] += 1
        a["total_ms"] += ev.get("dur_ms", 0.0)
    for a in agg.values():
        a["mean_ms"] = a["total_ms"] / a["count"]
    return agg


def render_by_name(report: dict, top: int = 0) -> str:
    agg = by_name(report.get("events", []))
    lines = [f"{'span':34s} {'cat':>10s} {'count':>7s} "
             f"{'total_ms':>10s} {'mean_ms':>9s}"]
    items = sorted(agg.items(), key=lambda kv: -kv[1]["total_ms"])
    for name, a in (items[:top] if top else items):
        lines.append(f"{name:34s} {a['cat']:>10s} {a['count']:7d} "
                     f"{a['total_ms']:10.2f} {a['mean_ms']:9.3f}")
    if not agg:
        lines.append("(no timeline events in this trace)")
    return "\n".join(lines)


def render(report: dict, top: int = 0) -> str:
    lines = []
    wall = report.get("wall_s")
    if wall is not None:
        lines.append(f"wall: {wall * 1e3:,.1f} ms")
    spans = report.get("spans", {})
    if spans:
        lines.append("")
        lines.append(f"{'span':34s} {'count':>7s} {'total_ms':>10s} "
                     f"{'p50_ms':>9s} {'p95_ms':>9s} {'p99_ms':>9s}")
        items = sorted(spans.items(),
                       key=lambda kv: -kv[1].get("total_ms", 0.0))
        for name, s in (items[:top] if top else items):
            lines.append(
                f"{name:34s} {s['count']:7d} {s['total_ms']:10.2f} "
                f"{s.get('p50', 0.0):9.3f} {s.get('p95', 0.0):9.3f} "
                f"{s.get('p99', 0.0):9.3f}")
    counters = report.get("counters", {})
    if counters:
        lines.append("")
        lines.append(f"{'counter':44s} {'value':>12s}")
        for name, value in sorted(counters.items()):
            lines.append(f"{name:44s} {value:12g}")
    gauges = report.get("gauges", {})
    if gauges:
        lines.append("")
        lines.append(f"{'gauge':44s} {'last':>8s} {'max':>8s}")
        for name, g in sorted(gauges.items()):
            lines.append(f"{name:44s} {g.get('value', 0):8g} "
                         f"{g.get('max', 0):8g}")
    hists = report.get("hists", {})
    if hists:
        lines.append("")
        lines.append(f"{'histogram':34s} {'count':>7s} {'mean':>10s} "
                     f"{'p50':>10s} {'p99':>10s} {'max':>10s}")
        for name, h in sorted(hists.items()):
            if not h.get("count"):
                continue
            lines.append(
                f"{name:34s} {h['count']:7d} {h.get('mean', 0):10.4g} "
                f"{h.get('p50', 0):10.4g} {h.get('p99', 0):10.4g} "
                f"{h.get('max', 0):10.4g}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="obs trace file (chrome json or jsonl)")
    ap.add_argument("--top", type=int, default=0,
                    help="show only the N spans with the largest total")
    ap.add_argument("--by-name", action="store_true",
                    help="only the per-span-name aggregation "
                    "(count/total/mean) from the raw timeline events")
    args = ap.parse_args(argv)
    try:
        report = load(args.trace)
    except (OSError, ValueError) as exc:
        print(f"repro_torch.obs.view: {exc}", file=sys.stderr)
        return 1
    if args.by_name:
        print(render_by_name(report, top=args.top))
    else:
        print(render(report, top=args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
