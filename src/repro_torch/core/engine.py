"""``QueryEngine``: exact-by-default queries with auto-sized buffers,
cached plans and CUDA kernel routing.

Counterpart of ``repro/core/engine.py``. The engine owns the
fixed-capacity knobs of :mod:`.queries` (``max_rows`` rows gathered per
range query, ``cap`` output slots per range list): it checks the
truncation flags and escalates through power-of-two buckets until
nothing truncates, and remembers where each query kind converged, so a
steady workload never escalates again.

Plans are cached on ``(op, Q-shape, dtype, k/caps, route, view shape)``.
PyTorch runs eagerly, so a plan is only the resolved route and its
parameters; :func:`trace_count` counts plan-cache misses, the
counterpart of the reference's jit traces, and the escalation bound
(O(log R) plans per query kind) holds against it.

Observability (:mod:`repro_torch.obs`, the reference's names):
``engine.plan_request`` per query call; ``engine.plan_miss`` per new
view-agnostic signature (the key of the reference's jitted closure
cache); ``engine.trace`` next to every :func:`trace_count` increment;
``engine.route.<route>`` per kNN call under the reference's route names
(``frontier``, ``pallas-frontier`` for the frontier kernel, ``flat``;
``QueryEngine.route_counts`` keeps the port's ``route:param``);
``engine.escalation_rounds`` / ``engine.escalation`` where range buffers
escalate; and, under ``Recorder(capture_costs=True)``, each plan's
device time and launches (:mod:`repro_torch.obs.costs`) under the
reference's signature strings (:func:`knn_signature`).

kNN routes (``impl``):

* ``auto``           -- ``cuda`` when the slot count ``R*C`` is at most
  :data:`DEFAULT_FLAT_BUDGET`, else ``cuda-frontier``
* ``cuda``           -- flat brute-force kernel (``kernels/knn``)
* ``plain``          -- its plain PyTorch version
* ``cuda-frontier``  -- fused frontier kernel (``kernels/frontier``)
* ``plain-frontier`` -- its plain PyTorch walk
* ``frontier``       -- the chunked traversal of :mod:`.queries`

The kernel routes take their plain versions on CPU tensors. Results are
canonical: each query's hits are sorted by ``(d2, id)``, so exact routes
agree bit for bit on tie-free data.
"""

from __future__ import annotations

import functools

from .. import obs
from ..kernels.frontier import ops as frontier_ops
from ..kernels.knn import ops as knn_ops
from . import queries

DEFAULT_MAX_ROWS = 128
DEFAULT_CAP = 512
DEFAULT_FLAT_BUDGET = 1 << 15

KNN_IMPLS = ("auto", "frontier", "cuda-frontier", "plain-frontier", "cuda",
             "plain")

_STATS = {"traces": 0}

# the reference's name of each kNN route, for engine.route.* counters
OBS_ROUTES = {"frontier": "frontier", "frontier-kernel": "pallas-frontier",
              "flat": "flat"}


# the reference's (route, param) spelling of each of the port's, for
# plan-cost signatures: the port's cuda kernels are the reference's
# auto-routed kernels, their plain versions its ref / interpret bodies
OBS_PARAMS = {("frontier-kernel", "cuda"): "auto",
              ("frontier-kernel", "plain"): "pallas-interpret",
              ("flat", "cuda"): "auto", ("flat", "plain"): "ref"}


def knn_signature(q: int, k: int, route: str, param, rows: int,
                  cols: int) -> str:
    """The reference's plan-cost signature of a kNN plan."""
    ref_param = OBS_PARAMS.get((route, param), param)
    return (f"knn.q{q}.k{int(k)}.{OBS_ROUTES[route]}-{ref_param}"
            f".v{rows}x{cols}")


def trace_count() -> int:
    """Query plans built this process (plan-cache misses)."""
    return _STATS["traces"]


def reset_trace_count() -> None:
    _STATS["traces"] = 0


def _pow2(x: int) -> int:
    """Smallest power of two >= x (>= 1)."""
    return 1 << max(int(x) - 1, 0).bit_length()


def auto_chunk(rows: int) -> int:
    """Frontier chunk width: ~R/16 rows per step, pow2, in [8, 128]."""
    return min(128, max(8, _pow2(rows // 16)))


def canonical_knn(d2, ids):
    """Sort each query's k hits by (d2, id) and re-pad empty slots."""
    return frontier_ops.sort_by_d2_id(d2, ids)


# ---------------------------------------------------------------------------
# cached plans
# ---------------------------------------------------------------------------

def _traced() -> None:
    _STATS["traces"] += 1
    obs.count("engine.trace")


@functools.lru_cache(maxsize=None)
def _plan_signature(*signature) -> None:
    """A plan's view-agnostic signature (the reference's jitted closure
    key): its first use counts ``engine.plan_miss``."""
    obs.count("engine.plan_miss")


@functools.lru_cache(maxsize=None)
def _knn_plan(q: int, dim: int, dtype: str, k: int, route: str, param,
              view_shape: tuple):
    _traced()
    if route == "frontier":
        def run(view, qpts):
            return canonical_knn(*queries.knn_impl(view, qpts, k, param))
    elif route == "frontier-kernel":
        def run(view, qpts):
            d2, ids = frontier_ops.knn_frontier_impl(
                view.pts, view.valid, view.active, view.bbox_lo,
                view.bbox_hi, qpts, k=k, impl=param)
            return canonical_knn(d2, ids)
    else:
        def run(view, qpts):
            pts, ok = queries.flatten_view(view)
            return canonical_knn(*knn_ops.knn_bruteforce(
                qpts, pts, ok, k=k, impl=param))
    return run


@functools.lru_cache(maxsize=None)
def _range_count_plan(q: int, dim: int, dtype: str, max_rows: int,
                      view_shape: tuple):
    _traced()
    return lambda view, lo, hi: queries.range_count_impl(view, lo, hi,
                                                         max_rows)


@functools.lru_cache(maxsize=None)
def _range_list_plan(q: int, dim: int, dtype: str, max_rows: int, cap: int,
                     view_shape: tuple):
    _traced()
    return lambda view, lo, hi: queries.range_list_impl(view, lo, hi,
                                                        max_rows, cap)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class QueryEngine:
    """Exact query planner/executor over leaf-row indexes. One engine
    rides along with each ``SpatialIndex`` lineage and holds only
    host-side planning state: the flat-scan budget, the converged buffer
    bucket per query kind, and how often each kNN route ran."""

    def __init__(self, *, flat_budget: int = DEFAULT_FLAT_BUDGET,
                 start_rows: int = DEFAULT_MAX_ROWS,
                 start_cap: int = DEFAULT_CAP):
        self.flat_budget = flat_budget
        self.start_rows = start_rows
        self.start_cap = start_cap
        self._buckets: dict = {}
        self.route_counts: dict[str, int] = {}

    def plan_knn(self, rows: int, cols: int, impl: str = "auto"):
        """Resolve an impl spelling to (route, param): ("frontier",
        chunk), ("frontier-kernel", kernel impl) or ("flat", kernel
        impl)."""
        if impl not in KNN_IMPLS:
            raise ValueError(f"unknown kNN impl {impl!r}; one of "
                             f"{KNN_IMPLS}")
        if impl == "auto":
            impl = "cuda" if rows * cols <= self.flat_budget else \
                "cuda-frontier"
        if impl == "frontier":
            return "frontier", auto_chunk(rows)
        if impl in ("cuda-frontier", "plain-frontier"):
            return "frontier-kernel", impl.split("-")[0]
        return "flat", impl

    def knn(self, view: queries.LeafView, qpts, k: int,
            impl: str = "auto"):
        """Exact batched kNN -> (d2 (Q, k) ascending, flat ids (Q, k) =
        row*C+slot, -1 padded), canonically (d2, id)-ordered."""
        rows, cols, dim = view.pts.shape
        route, param = self.plan_knn(rows, cols, impl)
        name = f"{route}:{param}"
        self.route_counts[name] = self.route_counts.get(name, 0) + 1
        obs.count("engine.plan_request")
        obs.count(f"engine.route.{OBS_ROUTES[route]}")
        sig = (qpts.shape[0], dim, str(qpts.dtype), int(k), route, param)
        _plan_signature("knn", *sig)
        plan = _knn_plan(*sig, tuple(view.pts.shape))
        if obs.costs.enabled():
            obs.costs.capture(plan, (view, qpts), knn_signature(
                qpts.shape[0], k, route, param, rows, cols))
        return plan(view, qpts)

    def range_count(self, view: queries.LeafView, lo, hi):
        """Exact batched range count -> counts (Q,), escalating the row
        buffer through power-of-two buckets until nothing truncates."""
        rows = view.pts.shape[0]
        key = ("range_count", lo.shape[0], lo.shape[-1], str(lo.dtype))
        max_rows = min(_pow2(self._buckets.get(key, self.start_rows)),
                       _pow2(rows))
        obs.count("engine.plan_request")
        rounds = 0
        while True:
            sig = (lo.shape[0], lo.shape[-1], str(lo.dtype), max_rows)
            _plan_signature("range_count", *sig)
            fn = _range_count_plan(*sig, tuple(view.pts.shape))
            if obs.costs.enabled():
                obs.costs.capture(fn, (view, lo, hi),
                                  f"range_count.q{lo.shape[0]}.r{max_rows}"
                                  f".v{rows}x{view.pts.shape[1]}")
            cnt, trunc = fn(view, lo, hi)
            if max_rows >= rows or not bool(trunc.any()):
                self._buckets[key] = max_rows
                obs.observe("engine.escalation_rounds", rounds)
                return cnt
            rounds += 1
            obs.count("engine.escalation")
            max_rows = min(2 * max_rows, _pow2(rows))

    def range_list(self, view: queries.LeafView, lo, hi):
        """Exact batched range report -> (ids (Q, cap) flat row*C+slot
        padded with -1, counts (Q,)); ``cap`` is the converged pow2
        bucket, clamped to the gathered-slot count ``max_rows*C``."""
        rows, cols, _ = view.pts.shape
        key = ("range_list", lo.shape[0], lo.shape[-1], str(lo.dtype))
        max_rows, cap = self._buckets.get(key, (self.start_rows,
                                                self.start_cap))
        max_rows = min(_pow2(max_rows), _pow2(rows))
        cap = min(_pow2(cap), max_rows * cols)
        obs.count("engine.plan_request")
        rounds = 0
        while True:
            sig = (lo.shape[0], lo.shape[-1], str(lo.dtype), max_rows, cap)
            _plan_signature("range_list", *sig)
            fn = _range_list_plan(*sig, tuple(view.pts.shape))
            if obs.costs.enabled():
                obs.costs.capture(fn, (view, lo, hi),
                                  f"range_list.q{lo.shape[0]}.r{max_rows}"
                                  f".c{cap}.v{rows}x{cols}")
            ids, cnt, rows_trunc = fn(view, lo, hi)
            need_rows = max_rows < rows and bool(rows_trunc.any())
            max_cnt = int(cnt.max()) if cnt.numel() else 0
            need_cap = cap < max_cnt
            if not (need_rows or need_cap):
                self._buckets[key] = (max_rows, cap)
                obs.observe("engine.escalation_rounds", rounds)
                return ids, cnt
            rounds += 1
            obs.count("engine.escalation")
            if need_rows:
                max_rows = min(2 * max_rows, _pow2(rows))
            if need_cap:
                # counts are exact once rows fit: jump to their bucket
                cap = max(2 * cap, _pow2(max_cnt))
            cap = min(cap, max_rows * cols)

