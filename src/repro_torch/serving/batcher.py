"""Query micro-batcher: coalesce kNN/range requests into pow2-padded
batches.

Counterpart of ``repro/serving/batcher.py``. Requests are queued per
plan signature ``(op, k, dim, dtype, impl)``, concatenated, and padded
to the next power of two by replicating the last row (rows are answered
independently, so padding never perturbs a real answer). Answers are
sliced back per request; because every engine route is exact and
canonically ``(d2, id)``-ordered, kNN and range-count answers bit-match
the answers the same requests get dispatched alone. Pow2 padding keeps a
ragged stream on O(log max_batch) query plans.

Admission is cooperative (no timer thread): a flush happens when pending
rows reach ``max_batch``, or when the oldest request has waited
``max_delay_s`` as observed at the next ``submit``, ``poll()`` or
``Ticket.result()`` (which always flushes what is pending).

Host (numpy) requests stay on the host until the flush: one concatenate
and one device transfer per coalesced batch. Tensor requests are
concatenated where they live.

Observability (:mod:`repro_torch.obs`, the reference's names): the
``batcher.queue_depth`` gauge at each enqueue, ``batcher.flush.<reason>``
per flush, and per coalesced group ``batcher.requests``, the
``batcher.coalesce_rows`` / ``batcher.pad_rows`` / ``batcher.wait_s``
histograms and a ``batcher.flush`` span. All host-side bookkeeping.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import obs
from ..core.engine import _pow2


def _as_rows(x):
    """One request payload as a 2-D row batch, left where it lives."""
    if isinstance(x, torch.Tensor):
        return torch.atleast_2d(x)
    return np.atleast_2d(x)


def _concat_pad(parts, rows: int):
    """Concatenate request payloads and pad to the next pow2 row count
    by replicating the last row."""
    if any(isinstance(p, torch.Tensor) for p in parts):
        col = torch.cat([torch.as_tensor(p) for p in parts])
        pad = _pow2(rows) - rows
        return torch.cat([col, col[-1:].expand(pad, -1)]) if pad else col
    col = np.concatenate(parts)
    pad = _pow2(rows) - rows
    return np.concatenate([col, np.repeat(col[-1:], pad, axis=0)]) \
        if pad else col


class Ticket:
    """Handle for one submitted request; ``result()`` flushes the owning
    batcher if the answer is not in yet."""

    __slots__ = ("_batcher", "_value", "_done")

    def __init__(self, batcher: "MicroBatcher"):
        self._batcher = batcher
        self._done = False
        self._value = None

    @property
    def done(self) -> bool:
        return self._done

    def result(self):
        if not self._done:
            self._batcher.flush(reason="result")
        if not self._done:
            raise RuntimeError("flush did not resolve this ticket")
        return self._value

    def _resolve(self, value) -> None:
        self._value = value
        self._done = True


class MicroBatcher:
    """Coalesces kNN / range-count / range-list requests per plan
    signature.

    ``target`` answers the flushed batches: a ``SpatialIndex``, a
    ``Snapshot``, or a zero-argument callable returning either (such as
    ``server.snapshot``, taken at flush time). Reassigning ``target``
    flushes pending requests against the old target first."""

    def __init__(self, target=None, *, max_batch: int = 1024,
                 max_delay_s: float = 0.002, clock=time.monotonic):
        self._target = target
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_s)
        self._clock = clock
        self._groups: dict[tuple, list] = {}
        self._pending_rows = 0
        self._oldest = None
        self.flushes = 0
        self.flush_reasons: dict[str, int] = {}

    @property
    def target(self):
        return self._target

    @target.setter
    def target(self, value):
        if self._pending_rows and value is not self._target:
            self.flush(reason="retarget")
        self._target = value

    # -- submission --------------------------------------------------------

    def submit_knn(self, qpts, k: int, *, impl: str = "auto") -> Ticket:
        """Queue a kNN request (1 or more query points); resolves to the
        ``(d2, ids)`` of ``index.knn(qpts, k, impl=impl)``."""
        qpts = _as_rows(qpts)
        key = ("knn", int(k), qpts.shape[1], str(qpts.dtype), impl)
        return self._enqueue(key, (qpts,), qpts.shape[0])

    def submit_range_count(self, lo, hi) -> Ticket:
        """Queue a range-count request (1 or more boxes)."""
        lo, hi = _as_rows(lo), _as_rows(hi)
        key = ("range_count", lo.shape[1], str(lo.dtype))
        return self._enqueue(key, (lo, hi), lo.shape[0])

    def submit_range_list(self, lo, hi) -> Ticket:
        """Queue a range-list request; resolves to ``(ids, counts)``."""
        lo, hi = _as_rows(lo), _as_rows(hi)
        key = ("range_list", lo.shape[1], str(lo.dtype))
        return self._enqueue(key, (lo, hi), lo.shape[0])

    def _enqueue(self, key: tuple, arrays: tuple, rows: int) -> Ticket:
        t = Ticket(self)
        now = self._clock()
        self._groups.setdefault(key, []).append((t, arrays, rows, now))
        self._pending_rows += rows
        obs.gauge("batcher.queue_depth", self._pending_rows)
        if self._oldest is None:
            self._oldest = now
        if self._pending_rows >= self.max_batch:
            self.flush(reason="size")
        elif now - self._oldest >= self.max_delay_s:
            self.flush(reason="deadline")
        return t

    @property
    def pending(self) -> int:
        """Queued request rows not yet flushed."""
        return self._pending_rows

    def poll(self) -> int:
        """Flush if the oldest request has passed the delay deadline;
        returns the number of engine calls issued."""
        if (self._oldest is not None
                and self._clock() - self._oldest >= self.max_delay_s):
            return self.flush(reason="deadline")
        return 0

    # -- execution ---------------------------------------------------------

    def _resolve_target(self):
        t = self.target() if callable(self.target) else self.target
        if t is None:
            raise ValueError("MicroBatcher.target is not set")
        return t

    def flush(self, *, reason: str = "explicit") -> int:
        """Run every pending group as one pow2-padded batch; returns the
        number of engine calls. ``reason`` (size | deadline | result |
        retarget | explicit) is counted in :attr:`flush_reasons` and on
        the ``batcher.flush.<reason>`` obs counter."""
        groups, self._groups = self._groups, {}
        self._pending_rows, self._oldest = 0, None
        if not groups:
            return 0
        self.flush_reasons[reason] = self.flush_reasons.get(reason, 0) + 1
        obs.count(f"batcher.flush.{reason}")
        target = self._resolve_target()
        now = self._clock()
        for key, reqs in groups.items():
            self._run_group(target, key, reqs, now)
        self.flushes += len(groups)
        return len(groups)

    def _run_group(self, target, key: tuple, reqs: list, now) -> None:
        op = key[0]
        q = sum(r[2] for r in reqs)
        obs.count("batcher.requests", len(reqs))
        obs.observe("batcher.coalesce_rows", q)
        obs.observe("batcher.pad_rows", _pow2(q) - q)
        if obs.enabled():
            for r in reqs:
                obs.observe("batcher.wait_s", now - r[3])
        with obs.span("batcher.flush", op=op, rows=q, reqs=len(reqs)):
            cols = [_concat_pad([r[1][i] for r in reqs], q)
                    for i in range(len(reqs[0][1]))]
            if op == "knn":
                outs = tuple(target.knn(cols[0], key[1], impl=key[4]))
            elif op == "range_count":
                outs = (target.range_count(cols[0], cols[1]),)
            else:
                outs = tuple(target.range_list(cols[0], cols[1]))
        start = 0
        for ticket, _, rows, _ in reqs:
            sl = tuple(o[start: start + rows] for o in outs)
            ticket._resolve(sl if len(sl) > 1 else sl[0])
            start += rows
