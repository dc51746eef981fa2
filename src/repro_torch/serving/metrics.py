"""Latency/throughput accounting for the serving runtime.

Counterpart of ``repro/serving/metrics.py``. The workload driver
(:mod:`repro_torch.serving.driver`) cares about the *distribution* of
per-op latency -- a service SLO is a p99, not a mean -- so this module
keeps per-op samples in :class:`repro_torch.obs.Hist` histograms (under
the ``lat.`` prefix) and reduces them to p50/p95/p99 (plus
mean/min/max) only at report time: exact (numpy's linear percentile)
while a histogram holds all its samples, pow2 bucket upper edges past
its retention (8,192 samples), as the reference reports them.
Wall-clock throughput (sustained q/s, update-points/s) is tracked
separately, so a pipelined run is credited for overlap.

Pass the driver's installed :class:`repro_torch.obs.Recorder` and the
percentiles, the library's own counters/spans and the exported trace
all come from one sink; with no recorder the class owns a private one.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np

from .. import obs

PERCENTILES = (50.0, 95.0, 99.0)

#: histogram-name prefix LatencyRecorder claims inside a shared Recorder
LAT_PREFIX = "lat."


def summarize(samples_s) -> dict:
    """Reduce one op's latency samples (seconds) to a stats dict (ms)."""
    a = np.asarray(sorted(samples_s), dtype=np.float64) * 1e3
    out = {"count": int(a.size)}
    if not a.size:
        return out
    for p in PERCENTILES:
        out[f"p{p:g}_ms"] = float(np.percentile(a, p))
    out["mean_ms"] = float(a.mean())
    out["min_ms"] = float(a[0])
    out["max_ms"] = float(a[-1])
    return out


class LatencyRecorder:
    """Per-op latency samples + wall-window op counters, backed by
    :class:`repro_torch.obs.Recorder` histograms.

    ``record`` during the measured window only — the driver runs its
    warm-up steps against a recorder that is then :meth:`reset`, so
    kernel builds and the query engine's pow2 bucket escalations (see
    ``repro_torch.core.engine``) never land in a percentile. ``reset``
    drops only the ``lat.`` histograms: a shared recorder's own
    counters/spans (plan-cache traffic, commit stalls, ...) keep
    accumulating across it, which is what trace export wants.
    """

    def __init__(self, clock=None, recorder: obs.Recorder | None = None):
        if recorder is not None:
            self._rec = recorder
            self._clock = clock if clock is not None else recorder.clock
        else:
            self._clock = clock if clock is not None else time.perf_counter
            # private sink: no timeline events, just the lat. histograms
            self._rec = obs.Recorder(clock=self._clock, keep_events=False)
        self.reset()

    @property
    def recorder(self) -> obs.Recorder:
        """The backing obs recorder (shared or private)."""
        return self._rec

    def reset(self) -> None:
        self._rec.drop(LAT_PREFIX)
        self._counts: dict[str, int] = defaultdict(int)
        self._t0 = self._clock()

    def record(self, op: str, seconds: float, units: int = 1,
               start: float | None = None) -> None:
        """One latency sample for ``op``; ``units`` feeds throughput
        (e.g. points in an update batch, requests in a query flush).
        Pass ``start`` (the sample's begin time on this recorder's
        clock) to also place the section on the exported timeline."""
        self._rec.observe(LAT_PREFIX + op, float(seconds))
        if start is not None:
            self._rec.add_span(LAT_PREFIX + op, start, float(seconds),
                               cat="latency", units=int(units))
        self._counts[op] += int(units)

    @contextlib.contextmanager
    def timer(self, op: str, units: int = 1):
        t0 = self._clock()
        yield
        self.record(op, self._clock() - t0, units, start=t0)

    @property
    def wall_s(self) -> float:
        return self._clock() - self._t0

    def count(self, op: str) -> int:
        return self._counts[op]

    def samples(self, op: str) -> list[float]:
        """Retained raw samples (seconds) for ``op``."""
        h = self._rec.hist(LAT_PREFIX + op)
        return list(h.samples) if h is not None else []

    def latency_summary(self) -> dict[str, dict]:
        """{op: {p50_ms, p95_ms, p99_ms, mean_ms, min_ms, max_ms,
        count}} over the measured window."""
        out = {}
        for name in sorted(self._rec.hists):
            if not name.startswith(LAT_PREFIX):
                continue
            h = self._rec.hists[name]
            # exact per-sample reduction while retention holds (the
            # driver's bounded windows), pow2-bucket fallback past it
            if h.dropped:
                s = h.summary(scale=1e3)
                out[name[len(LAT_PREFIX):]] = {
                    "count": s["count"], "mean_ms": s["mean"],
                    "min_ms": s["min"], "max_ms": s["max"],
                    **{f"p{p:g}_ms": s[f"p{p:g}"] for p in PERCENTILES}}
            else:
                out[name[len(LAT_PREFIX):]] = summarize(h.samples)
        return out

    def throughput(self, ops) -> dict[str, float]:
        """Sustained units/s per op over the shared wall window (ops
        overlap on device, so these are *service* rates, not inverse
        latencies)."""
        wall = max(self.wall_s, 1e-9)
        return {op: self._counts[op] / wall for op in ops}
