"""Recorder core: spans, counters, gauges, pow2 histograms, and the
deferred device-read list.

Counterpart of ``repro/obs/record.py``, with the same names, schema and
reductions. Everything here is host-side Python over stdlib types:
``torch`` is imported only inside :meth:`Recorder.resolve`, the one
place that reads a device value, so enabling obs never changes what the
instrumented code launches.

Two invariants this module owns:

* **No host sync off the barrier.** Instrumented code may *attach*
  in-flight device tensors to a span (:meth:`Span.defer`) or to a named
  counter (:meth:`Recorder.add_deferred`); both are list appends. The
  host read (``.item()`` / ``.tolist()``, once per entry) happens only
  in :meth:`Recorder.resolve`, which callers invoke at an existing
  barrier (``SpatialServer.commit``, report time).
  ``tests/test_torch_obs.py`` holds this package to it with the
  reference's ``obs-deferred-sync`` rule pointed at this package.
* **Disabled mode is near-free.** The module-level helpers in
  :mod:`repro_torch.obs` check one dict slot and return a shared no-op
  span when no recorder is installed; nothing is allocated and no clock
  is read.

Histograms bucket observations by power of two (bucket key = the
smallest ``2**e`` >= value, 0 for 0) and retain up to ``max_samples``
raw samples, so report-time percentiles (p50/p95/p99) are exact for
bounded runs like the workload driver's and fall back to bucket upper
edges past retention.
"""

from __future__ import annotations

import math
import threading
import time


def pow2_bucket(value) -> float:
    """Upper edge of the power-of-two bucket holding ``value``:
    smallest ``2.0**e`` >= value (0.0 for values <= 0)."""
    v = float(value)
    if v <= 0.0:
        return 0.0
    m, e = math.frexp(v)          # v = m * 2**e, 0.5 <= m < 1
    return float(2.0 ** (e - 1 if m == 0.5 else e))


def percentile(sorted_samples, p: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    n = len(sorted_samples)
    if not n:
        return 0.0
    rank = min(n - 1, max(0, math.ceil(p / 100.0 * n) - 1))
    return float(sorted_samples[rank])


class Hist:
    """Pow2-bucket histogram with bounded raw-sample retention."""

    __slots__ = ("buckets", "samples", "count", "total", "min", "max",
                 "max_samples", "dropped")

    def __init__(self, max_samples: int = 8192):
        self.buckets: dict[float, int] = {}
        self.samples: list[float] = []
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.max_samples = max_samples
        self.dropped = 0              # samples past retention (buckets
                                      # still count them)

    def observe(self, value) -> None:
        v = float(value)
        b = pow2_bucket(v)
        self.buckets[b] = self.buckets.get(b, 0) + 1
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        if len(self.samples) < self.max_samples:
            self.samples.append(v)
        else:
            self.dropped += 1

    def summary(self, scale: float = 1.0) -> dict:
        """count/mean/min/max plus p50/p95/p99 — exact from retained
        samples, falling back to bucket upper edges past retention."""
        if not self.count:
            return {"count": 0}
        out = {"count": self.count,
               "mean": scale * self.total / self.count,
               "min": scale * self.min, "max": scale * self.max}
        if self.dropped:
            # percentile from bucket edges (upper bounds -> pessimistic)
            edges = sorted(self.buckets)
            cum, spread = 0, []
            for e in edges:
                spread.extend([e] * self.buckets[e])
            samples = spread
        else:
            samples = sorted(self.samples)
        for p in (50.0, 95.0, 99.0):
            out[f"p{p:g}"] = scale * percentile(samples, p)
        return out

    def to_dict(self) -> dict:
        return {"buckets": {repr(k): v
                            for k, v in sorted(self.buckets.items())},
                **self.summary()}


class Span:
    """One timed section. Use as a context manager (the common path) or
    drive ``begin()``/``end()`` by hand. ``set()`` adds attributes;
    ``defer()`` attaches an in-flight device value whose host read is
    postponed to the owning recorder's :meth:`Recorder.resolve`."""

    __slots__ = ("rec", "name", "cat", "args", "t0", "dur")

    def __init__(self, rec: "Recorder", name: str, cat: str, args: dict):
        self.rec = rec
        self.name = name
        self.cat = cat
        self.args = args
        self.t0 = None
        self.dur = None

    def __enter__(self) -> "Span":
        self.t0 = self.rec.clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.end()
        return False

    def begin(self) -> "Span":
        return self.__enter__()

    def end(self) -> None:
        self.dur = self.rec.clock() - self.t0
        self.rec._finish(self)

    def set(self, **attrs) -> "Span":
        self.args.update(attrs)
        return self

    def defer(self, key: str, value) -> "Span":
        """Attach an in-flight device value; ``args[key]`` is filled in
        (plus ``<key>_resolved_s``, the barrier-side completion stamp)
        at the recorder's next ``resolve()``. Never reads the value."""
        # placeholder keeps args non-empty so _finish retains the dict
        # (resolve() mutates it in place after the span has ended)
        self.args[key] = None
        with self.rec._lock:
            self.rec._pending.append((self.args, key, value))
        return self

    @property
    def done(self) -> bool:
        return self.dur is not None


class NullSpan:
    """Shared no-op stand-in returned while obs is disabled: every
    method is a cheap self-return, so instrumentation sites cost one
    dict lookup and an attribute call."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def begin(self):
        return self

    def end(self):
        return None

    def set(self, **attrs):
        return self

    def defer(self, key, value):
        return self

    done = True


NULL_SPAN = NullSpan()


class Recorder:
    """Collects spans/counters/gauges/histograms for one run.

    Host-side only: ``clock`` is a monotonic timer (``perf_counter``),
    events are plain dicts, and the only device interaction is the
    deferred-read list drained by :meth:`resolve` at a barrier.

    Thread-safe: the batcher's worker threads and the main thread mutate
    counters/hists concurrently, so every read-modify-write goes through
    one uncontended lock (the disabled path in :mod:`repro_torch.obs` never
    reaches it).

    Opt-in extra (default off, drained at barriers only):

    * ``memory_snapshots`` -- each :meth:`resolve` also records the CUDA
      caching allocator's gauges (``backend.mem.d<id>.*``) from
      ``torch.cuda.memory_stats``; that call queries the device runtime,
      so it is made only inside ``resolve``.

    * ``capture_costs`` -- :mod:`repro_torch.obs.costs` runs each new
      query/update plan once more under ``torch.profiler`` at its
      plan-miss site and records ``plan.cost.<sig>.device_us`` and
      ``.launches``; ``_cost_sigs`` tracks the signatures captured and
      ``cost_kernels`` their kernels by name.
    """

    def __init__(self, clock=time.perf_counter, max_samples: int = 8192,
                 keep_events: bool = True, capture_costs: bool = False,
                 memory_snapshots: bool = False):
        self.clock = clock
        self.keep_events = keep_events
        self.max_samples = max_samples
        self.memory_snapshots = memory_snapshots
        self.capture_costs = capture_costs
        self._cost_sigs: set[str] = set()  # plan sigs already captured
        self.cost_kernels: dict[str, dict[str, int]] = {}
        self.events: list[dict] = []       # completed spans, in order
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, dict] = {}  # name -> {value, max, n}
        self.hists: dict[str, Hist] = {}
        self._pending: list[tuple[dict | str, str | None, object]] = []
        self._lock = threading.Lock()
        self.t0 = self.clock()

    # -- spans -------------------------------------------------------------

    def span(self, name: str, cat: str = "", **attrs) -> Span:
        return Span(self, name, cat, attrs)

    def _finish(self, span: Span) -> None:
        if self.keep_events:
            ev = {"name": span.name, "ts": span.t0 - self.t0,
                  "dur": span.dur}
            if span.cat:
                ev["cat"] = span.cat
            if span.args:
                ev["args"] = span.args
            with self._lock:
                self.events.append(ev)

    def add_span(self, name: str, start_s: float, dur_s: float,
                 cat: str = "", **attrs) -> None:
        """Record an externally-timed section on the timeline
        (``start_s`` in this recorder's clock base)."""
        if self.keep_events:
            ev = {"name": name, "ts": start_s - self.t0, "dur": dur_s}
            if cat:
                ev["cat"] = cat
            if attrs:
                ev["args"] = attrs
            with self._lock:
                self.events.append(ev)

    # -- metrics -----------------------------------------------------------

    def count(self, name: str, n: float = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value) -> None:
        with self._lock:
            g = self.gauges.get(name)
            if g is None:
                self.gauges[name] = {"value": value, "max": value, "n": 1}
            else:
                g["value"] = value
                if value > g["max"]:
                    g["max"] = value
                g["n"] += 1

    def observe(self, name: str, value) -> None:
        with self._lock:
            h = self.hists.get(name)
            if h is None:
                h = self.hists[name] = Hist(self.max_samples)
            h.observe(value)

    def hist(self, name: str) -> Hist | None:
        return self.hists.get(name)

    def drop(self, prefix: str) -> None:
        """Forget histograms under a name prefix (e.g. a latency
        recorder resetting its measured window after warmup)."""
        with self._lock:
            for name in [n for n in self.hists if n.startswith(prefix)]:
                del self.hists[name]

    # -- deferred device reads (resolve at barriers only) ------------------

    def add_deferred(self, name: str, value) -> None:
        """Attach an in-flight device scalar to counter ``name``; it is
        folded in (via one host read) at the next ``resolve()``."""
        with self._lock:
            self._pending.append((name, None, value))

    @property
    def pending(self) -> int:
        """Deferred device reads not yet resolved."""
        return len(self._pending)

    def resolve(self) -> int:
        """THE sync point: drain the deferred list with one host read per
        entry (``.item()`` for a one-element tensor, ``.tolist()``
        otherwise). Call only from an existing barrier (``commit()``,
        report time); everywhere else obs stays sync-free.

        With ``memory_snapshots`` on, also records the allocator gauges
        of every CUDA device here (``torch.cuda.memory_stats`` is a
        device-runtime query, so this is the only place that calls it)."""
        with self._lock:
            pending, self._pending = self._pending, []
        if self.memory_snapshots:
            import torch  # deferred import: obs stays stdlib-importable
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                for d in range(torch.cuda.device_count()):
                    stats = torch.cuda.memory_stats(d)
                    used = stats.get("allocated_bytes.all.current")
                    if used is not None:
                        self.gauge(f"backend.mem.d{d}.bytes_in_use",
                                   int(used))
                    peak = stats.get("allocated_bytes.all.peak")
                    if peak is not None:
                        self.gauge(f"backend.mem.d{d}.peak_bytes",
                                   int(peak))
        for target, key, value in pending:
            if hasattr(value, "numel"):       # a tensor: one host read
                value = value.item() if value.numel() == 1 else \
                    value.tolist()
            now = self.clock() - self.t0
            if isinstance(target, str):           # deferred counter
                self.count(target, float(value))
            else:                                 # span attribute
                try:
                    target[key] = float(value)
                except (TypeError, ValueError):   # non-scalar payload
                    target[key] = True
                target[f"{key}_resolved_s"] = now
        return len(pending)

    # -- reporting ---------------------------------------------------------

    def report(self) -> dict:
        """Resolve pending reads and reduce everything to one json-able
        payload (the shape the exporters and the view CLI consume)."""
        self.resolve()
        return {
            "wall_s": self.clock() - self.t0,
            "counters": dict(sorted(self.counters.items())),
            "gauges": {k: dict(v)
                       for k, v in sorted(self.gauges.items())},
            "hists": {k: v.to_dict()
                      for k, v in sorted(self.hists.items())},
            "spans": self.span_summary(),
            **({"plan_kernels": dict(sorted(self.cost_kernels.items()))}
               if self.cost_kernels else {}),
        }

    def span_summary(self) -> dict:
        """Per-name span stats (count, total/mean/p50/p95/p99 ms)."""
        by_name: dict[str, Hist] = {}
        for ev in self.events:
            h = by_name.get(ev["name"])
            if h is None:
                h = by_name[ev["name"]] = Hist(self.max_samples)
            h.observe(ev["dur"])
        out = {}
        for name, h in sorted(by_name.items()):
            s = h.summary(scale=1e3)           # ms
            s["total_ms"] = h.total * 1e3
            out[name] = s
        return out
