"""Latency/throughput accounting for the serving runtime.

Counterpart of ``repro/serving/metrics.py``: raw per-op latency samples
reduced to p50/p95/p99 (plus mean/min/max) with numpy at report time,
and per-op unit counts over one shared wall window for sustained rates
(a pipelined run is credited for overlap). The reference keeps its
samples in ``repro.obs`` histograms; the port keeps plain lists.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np

PERCENTILES = (50.0, 95.0, 99.0)


def summarize(samples_s) -> dict:
    """Reduce one op's latency samples (seconds) to a stats dict (ms)."""
    a = np.sort(np.asarray(samples_s, dtype=np.float64)) * 1e3
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
    """Per-op latency samples plus wall-window unit counters. Record
    during the measured window only: :meth:`reset` drops warm-up
    samples (kernel builds, bucket escalations) and restarts the
    window."""

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self.reset()

    def reset(self) -> None:
        self._samples: dict[str, list[float]] = defaultdict(list)
        self._counts: dict[str, int] = defaultdict(int)
        self._t0 = self._clock()

    def record(self, op: str, seconds: float, units: int = 1) -> None:
        """One latency sample for ``op``; ``units`` feeds throughput
        (points in an update batch, requests in a query flush)."""
        self._samples[op].append(float(seconds))
        self._counts[op] += int(units)

    @contextlib.contextmanager
    def timer(self, op: str, units: int = 1):
        t0 = self._clock()
        yield
        self.record(op, self._clock() - t0, units)

    @property
    def wall_s(self) -> float:
        return self._clock() - self._t0

    def count(self, op: str) -> int:
        return self._counts[op]

    def samples(self, op: str) -> list[float]:
        """Raw samples (seconds) for ``op``."""
        return list(self._samples.get(op, ()))

    def latency_summary(self) -> dict[str, dict]:
        """{op: {p50_ms, p95_ms, p99_ms, mean_ms, min_ms, max_ms, count}}
        over the measured window."""
        return {op: summarize(s) for op, s in sorted(self._samples.items())}

    def throughput(self, ops) -> dict[str, float]:
        """Sustained units/s per op over the shared wall window."""
        wall = max(self.wall_s, 1e-9)
        return {op: self._counts[op] / wall for op in ops}
