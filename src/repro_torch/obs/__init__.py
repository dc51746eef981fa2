"""``repro_torch.obs``: host-sync-free tracing, counters and trace export
for the port's index -> engine -> server stack.

Counterpart of ``repro/obs``, with the same names, record schema and
reductions, so a trace of either package reads in either viewer. Every
helper below is host-side bookkeeping (monotonic clock reads, dict
updates, list appends); device tensors are *attached* to spans and
counters and read only at :func:`resolve`, called from existing barriers
(``SpatialServer.commit``, report time). Spans time dispatch on the
host, not device work.

Usage::

    from repro_torch import obs

    rec = obs.Recorder()
    obs.install(rec)                    # or: with obs.recording(rec):
    with obs.span("serve.step", kind="insert") as sp:
        idx = idx.insert(batch)         # queued on the card
        sp.defer("rows", idx.size)      # attach, don't read
    obs.count("steps")
    obs.observe("batch_rows", 512)      # pow2-bucket histogram
    ...
    obs.resolve()                       # at a barrier: one read each
    obs.write_chrome_trace(rec, "trace.json")    # Perfetto-viewable
    # then: python -m repro_torch.obs.view trace.json

Disabled (no recorder installed) every helper is a near-free no-op:
``span()`` returns the shared :data:`NULL_SPAN` and the counter and
histogram helpers return after one dict-slot check, so instrumentation
stays in the hot path unconditionally.

Instrumented (counter and span names are the reference's):

====================================  =================================
``engine.plan_request/_miss``         query-plan cache traffic (a miss
                                      is a new view-agnostic signature)
``engine.trace``                      plans built per view shape --
                                      equals ``engine.trace_count``
``engine.route.<route>``              kNN routing decisions, under the
                                      reference's route names
                                      (``frontier``, ``pallas-frontier``
                                      for the frontier kernel, ``flat``)
``engine.escalation_rounds``          pow2 buffer escalations per call
``engine.escalation``                 extra escalation rounds
``index.grow/compact/build_retry``    capacity-recovery ladder events
``index.rebuild_retry``               kd/zd rebuilds redone with more rows
``index.recover_insert`` span         one insert's recovery ladder
``serving.insert|delete`` spans       update dispatch latency
``serving.evict_block`` span          version-window backpressure stall
``serving.replay`` span               deferred-overflow replays
``serving.commit`` span               exposed commit stall
``batcher.queue_depth`` gauge         rows pending at each enqueue
``batcher.requests``                  requests answered by flushes
``batcher.coalesce_rows/pad_rows``    flush batch size / pad waste
``batcher.wait_s``                    request queue wait (submit->flush)
``batcher.flush`` span                one coalesced engine call
``batcher.flush.<reason>``            size|deadline|result|retarget|
                                      explicit
``server.mem.live_bytes``             head-version tensor bytes (gauge)
``server.mem.window_bytes``           retained-window bytes (gauge)
``server.mem.evicted_bytes``          bytes freed by window eviction
``server.mem.evictions``              window evictions
``backend.mem.d<id>.bytes_in_use``    allocator stats, resolve()-only
                                      (``memory_snapshots=True``)
``lat.<op>``                          the driver's latency histograms
                                      (``serving.metrics``)
====================================  =================================

Not emitted: ``index.update_plan_miss`` (eager PyTorch compiles no
update closures) and ``plan.cost.*`` (no compiled program whose cost
could be read; ``Recorder(capture_costs=True)`` raises).
"""

from __future__ import annotations

import contextlib

from .export import (chrome_trace, jsonl_records, write_chrome_trace,
                     write_jsonl)
from .memory import fmt_bytes, tree_bytes
from .record import NULL_SPAN, Hist, NullSpan, Recorder, Span, pow2_bucket

__all__ = [
    "Recorder", "Span", "NullSpan", "NULL_SPAN", "Hist", "pow2_bucket",
    "install", "uninstall", "recording", "enabled", "recorder",
    "span", "count", "gauge", "observe", "defer", "resolve",
    "chrome_trace", "jsonl_records", "write_chrome_trace", "write_jsonl",
    "tree_bytes", "fmt_bytes",
]

# single mutable slot so the disabled-path check is one dict lookup
_STATE: dict = {"rec": None}


def install(rec: Recorder) -> Recorder:
    """Make ``rec`` the process-wide sink for the module-level helpers
    (instrumented library code records through these)."""
    _STATE["rec"] = rec
    return rec


def uninstall() -> None:
    _STATE["rec"] = None


def enabled() -> bool:
    return _STATE["rec"] is not None


def recorder() -> Recorder | None:
    """The installed recorder, or None while disabled."""
    return _STATE["rec"]


@contextlib.contextmanager
def recording(rec: Recorder | None = None):
    """Scoped install: enable obs for a block, restoring the previous
    state (including disabled) on exit. Yields the recorder."""
    rec = rec if rec is not None else Recorder()
    prev = _STATE["rec"]
    _STATE["rec"] = rec
    try:
        yield rec
    finally:
        _STATE["rec"] = prev


# -- instrumentation surface (near-free when disabled) ----------------------

def span(name: str, cat: str = "", **attrs):
    rec = _STATE["rec"]
    if rec is None:
        return NULL_SPAN
    return rec.span(name, cat, **attrs)


def count(name: str, n: float = 1) -> None:
    rec = _STATE["rec"]
    if rec is not None:
        rec.count(name, n)


def gauge(name: str, value) -> None:
    rec = _STATE["rec"]
    if rec is not None:
        rec.gauge(name, value)


def observe(name: str, value) -> None:
    rec = _STATE["rec"]
    if rec is not None:
        rec.observe(name, value)


def defer(name: str, value) -> None:
    """Attach an in-flight device scalar to counter ``name``; folded in
    at the next :func:`resolve` (no host read here)."""
    rec = _STATE["rec"]
    if rec is not None:
        rec.add_deferred(name, value)


def resolve() -> int:
    """Drain deferred device reads -- call from an existing barrier only
    (``commit()``, report time); returns the number resolved."""
    rec = _STATE["rec"]
    return rec.resolve() if rec is not None else 0
