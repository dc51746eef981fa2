"""Synthetic spatial workloads (the paper's Sec. 5.1), in numpy.

Counterpart of ``repro/data/points.py``, with the same shapes and
semantics:

* Uniform   -- i.i.d. uniform integer coordinates in ``[0, hi)``.
* Sweepline -- uniform points sorted along dim 0 (skewed update order).
* Varden    -- random walk with restarts (clustered points).

:func:`make_trace` builds the serving runtime's deterministic update
traces: churn over each distribution plus ``moving-objects`` and
``sliding-window``. Every generator is deterministic in its seed, but the
numbers differ from the reference's ``jax.random`` streams for the same
seed: tests that compare the two packages make their inputs once with
numpy and hand the same arrays to both.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

DEFAULT_HI = 1 << 20  # coordinate range [0, 2^20)


def _rng(seed) -> np.random.Generator:
    return seed if isinstance(seed, np.random.Generator) else \
        np.random.default_rng(seed)


def uniform(seed, n: int, dim: int = 2, hi: int = DEFAULT_HI):
    return _rng(seed).integers(0, hi, size=(n, dim), dtype=np.int32)


def sweepline(seed, n: int, dim: int = 2, hi: int = DEFAULT_HI):
    p = uniform(seed, n, dim, hi)
    return p[np.argsort(p[:, 0], kind="stable")]


def varden(seed, n: int, dim: int = 2, hi: int = DEFAULT_HI, step: int = 50,
           restart_p: float = 0.01):
    """Random walk with restarts: each point is the previous one moved by
    a step in ``[-step, step]`` per dim (clipped to the domain), or a
    fresh uniform point with probability ``restart_p``.

    Between restarts the walk is a cumulative sum until it first leaves
    the domain, so each segment is summed at once and only the tail of a
    segment that reaches an edge is walked point by point (a small share
    of the points, so 10^7 points take seconds)."""
    rng = _rng(seed)
    steps = rng.integers(-step, step + 1, size=(n, dim), dtype=np.int64)
    restarts = rng.random(n) < restart_p
    restart_pos = rng.integers(0, hi, size=(n, dim), dtype=np.int64)
    if n == 0:
        return np.empty((0, dim), np.int32)
    starts = restarts.copy()
    starts[0] = True
    first = np.flatnonzero(starts)
    seg = np.cumsum(starts) - 1                   # segment of each point
    base = restart_pos[first]
    if not restarts[0]:                           # the walk's first step
        base[0] = np.clip(restart_pos[0] + steps[0], 0, hi - 1)
    csum = np.cumsum(steps, axis=0)
    out = base[seg] + csum - csum[first][seg]
    off = ((out < 0) | (out > hi - 1)).any(axis=1)
    ends = np.append(first[1:], n)
    for i in np.flatnonzero(off):
        if off[i]:
            # the segment's first point lies in the domain, and the
            # unclipped sum is exact up to i - 1: walk the rest
            s = seg[i]
            cur = out[i - 1]
            for j in range(i, ends[s]):
                cur = np.clip(cur + steps[j], 0, hi - 1)
                out[j] = cur
            off[i: ends[s]] = False
    return out.astype(np.int32)


GENERATORS = {"uniform": uniform, "sweepline": sweepline, "varden": varden}


class TraceStep(NamedTuple):
    """One serving step: apply ``delete`` (may be None), then ``insert``
    (may be None); queries interleave against the pre-step snapshot."""
    delete: np.ndarray | None
    insert: np.ndarray | None


class Trace(NamedTuple):
    """A deterministic mixed update workload for the serving runtime."""
    bootstrap: np.ndarray         # initial index contents
    steps: tuple[TraceStep, ...]  # replayed in order
    max_live: int                 # peak live points (sizes capacity)

    @property
    def final_size(self) -> int:
        """Live points after every step (deletes hit live points)."""
        return int(self.bootstrap.shape[0]) + sum(
            (0 if s.insert is None else int(s.insert.shape[0]))
            - (0 if s.delete is None else int(s.delete.shape[0]))
            for s in self.steps)


def _trace_of(bootstrap, steps) -> Trace:
    live = peak = int(bootstrap.shape[0])
    for s in steps:
        live += (0 if s.insert is None else int(s.insert.shape[0])) \
            - (0 if s.delete is None else int(s.delete.shape[0]))
        peak = max(peak, live)
    return Trace(bootstrap, tuple(steps), peak)


def trace_churn(dist: str, *, seed: int = 0, n: int, batch: int,
                steps: int, dim: int = 2, hi: int = DEFAULT_HI) -> Trace:
    """Bootstrap ``n`` points from ``dist``; each step inserts the next
    stream batch and retires a quarter of the previous batch (step 0
    retires from the bootstrap tail)."""
    pts = GENERATORS[dist](seed, n + steps * batch, dim, hi)
    prev = pts[max(n - batch, 0): n]
    out = []
    for s in range(steps):
        ins = pts[n + s * batch: n + (s + 1) * batch]
        out.append(TraceStep(delete=prev[: batch // 4], insert=ins))
        prev = ins
    return _trace_of(pts[:n], out)


def trace_moving_objects(*, seed: int = 0, n: int, batch: int,
                         steps: int, dim: int = 2, hi: int = DEFAULT_HI,
                         disp: int = 2000) -> Trace:
    """Kinetic points: each step a rotating block of ``batch`` of the
    ``n`` objects moves by a displacement in ``[-disp, disp]`` (delete
    the old positions, insert the new ones)."""
    if batch > n:
        raise ValueError(f"moving-objects needs batch <= n objects, got "
                         f"batch={batch} > n={n}")
    rng = np.random.default_rng(seed)
    pos0 = uniform(rng, n, dim, hi)
    pos, out = pos0.copy(), []
    for s in range(steps):
        sel = (np.arange(batch) + s * batch) % n
        old = pos[sel]
        delta = rng.integers(-disp, disp + 1, size=(batch, dim),
                             dtype=np.int32)
        new = np.clip(old + delta, 0, hi - 1).astype(np.int32)
        pos[sel] = new
        out.append(TraceStep(delete=old, insert=new))
    return _trace_of(pos0, out)


def trace_sliding_window(*, seed: int = 0, n: int, batch: int,
                         steps: int, dim: int = 2, hi: int = DEFAULT_HI,
                         dist: str = "uniform") -> Trace:
    """Stream window: bootstrap the first ``n`` stream points; step ``s``
    inserts the next ``batch`` and deletes the oldest ``batch``."""
    if batch > n:
        raise ValueError(f"sliding-window needs batch <= n window "
                         f"points, got batch={batch} > n={n}")
    pts = GENERATORS[dist](seed, n + steps * batch, dim, hi)
    out = [TraceStep(delete=pts[s * batch: (s + 1) * batch],
                     insert=pts[n + s * batch: n + (s + 1) * batch])
           for s in range(steps)]
    return _trace_of(pts[:n], out)


TRACES = {"moving-objects": trace_moving_objects,
          "sliding-window": trace_sliding_window}

SCENARIOS = tuple(GENERATORS) + tuple(TRACES)


def make_trace(scenario: str, *, seed: int = 0, n: int, batch: int,
               steps: int, dim: int = 2, hi: int = DEFAULT_HI) -> Trace:
    """The named scenario's trace: a ``GENERATORS`` name runs churn over
    that distribution; a ``TRACES`` name runs its own shape."""
    if scenario in GENERATORS:
        return trace_churn(scenario, seed=seed, n=n, batch=batch,
                           steps=steps, dim=dim, hi=hi)
    if scenario in TRACES:
        return TRACES[scenario](seed=seed, n=n, batch=batch, steps=steps,
                                dim=dim, hi=hi)
    raise KeyError(f"unknown scenario {scenario!r}; one of {SCENARIOS}")


def query_boxes(seed, n: int, dim: int, side: int, hi: int = DEFAULT_HI):
    """Axis-aligned inclusive query boxes with extent in
    ``[side // 2, side]`` per dim."""
    rng = _rng(seed)
    lo = rng.integers(0, hi - side, size=(n, dim), dtype=np.int32)
    ext = rng.integers(side // 2, side + 1, size=(n, dim), dtype=np.int32)
    return lo, lo + ext
