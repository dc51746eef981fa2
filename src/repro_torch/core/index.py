"""Unified ``SpatialIndex`` facade over the ported tree families.

Counterpart of ``repro/core/index.py``: a string-keyed backend registry
plus a thin handle, so callers write

    idx = make_index("spac-h", points, phi=32)     # on the card
    idx = idx.insert(batch)
    d2, ids = idx.knn(queries, k=10)

and never touch ``capacity_rows``, ``overflowed``, ``grow`` or
``compact`` by hand. Row capacity comes from :func:`capacity_for`; an
insert that overflows is recovered through the ladder
``grow -> retry -> compact -> retry``.

PyTorch runs eagerly, so there are no update closures to cache: an
update is the backend's function called on the tree's tensors, and
queries go through the per-index :class:`QueryEngine`. For the same
reason the reference's ``index.update_plan_miss`` counter has no event
here and is not emitted; the capacity ladder records the reference's
``index.grow`` / ``index.compact`` counters and ``index.recover_insert``
span, and retried builds and rebuilds ``index.build_retry`` /
``index.rebuild_retry`` (:mod:`repro_torch.obs`).

Registered kinds: ``porth`` (the P-Orth tree), ``spac-h``, ``spac-z``,
``spac-m`` (alias of spac-z), ``cpam-h`` and ``cpam-z`` (dynamic: updated
in place in fixed arrays with a sticky ``overflowed`` flag), and the
rebuild baselines ``kd`` and ``zd`` (each update re-runs the build; the
facade sizes rows from a host-side bound on live points and verifies the
rebuilt size, so their updates synchronise). The reference's
mesh-sharded ``DistributedIndex`` is not ported yet.

Entry points run on the card: ``make_index(..., device=None)`` resolves
to CUDA and raises on a host without it (see :mod:`repro_torch.device`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .. import obs
from ..device import resolve_device
from ..obs.memory import tree_bytes
from . import baselines, porth, queries, spac
from .engine import QueryEngine

DEFAULT_ROOT_HI = 1 << 20   # porth root for integer points: [0, 2^20)


# ---------------------------------------------------------------------------
# capacity policy
# ---------------------------------------------------------------------------

def capacity_for(n_points: int, phi: int = 32, slack: int = 4) -> int:
    """Shared row-capacity heuristic: rows for ``n_points`` with
    ``slack``x headroom over the dense packing."""
    return int(slack) * ((int(n_points) + phi - 1) // phi) + 64


def _round_capacity(rows: int) -> int:
    """Round up to a power of two (at least 2^15)."""
    return 1 << max(int(rows) - 1, 15).bit_length()


# ---------------------------------------------------------------------------
# backend registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Backend:
    """Adapter spec every tree family registers: ``build(points, mask, *,
    phi, capacity_rows, **build_params)``, ``insert/delete(tree, pts,
    mask, **params)`` and ``resolve(params, points)`` to fill
    data-dependent defaults. ``dynamic`` backends update in place (fixed
    arrays and an ``overflowed`` flag) and provide ``grow``/``compact``
    for capacity recovery; rebuild backends re-run ``build`` and take
    ``capacity_rows`` as an update param instead."""
    name: str
    build: Callable[..., Any]
    insert: Callable[..., Any]
    delete: Callable[..., Any]
    dynamic: bool
    grow: Callable[..., Any] | None = None
    compact: Callable[..., Any] | None = None
    cap_slack: int = 4
    build_params: tuple[str, ...] = ()
    insert_params: tuple[str, ...] = ()
    delete_params: tuple[str, ...] = ()
    defaults: dict[str, Any] = dataclasses.field(default_factory=dict)
    resolve: Callable[[dict, Any], dict] | None = None


BACKENDS: dict[str, Backend] = {}


def register_backend(backend: Backend) -> None:
    """Add (or replace) a backend under ``backend.name``."""
    BACKENDS[backend.name] = backend


def get_backend(kind: str) -> Backend:
    try:
        return BACKENDS[kind]
    except KeyError:
        raise KeyError(f"unknown index kind {kind!r}; registered: "
                       f"{sorted(BACKENDS)}") from None


def _porth_resolve(params: dict, points) -> dict:
    """lam = 3 in 2D and 2 in 3D (the paper's choice); the root cell is
    [0, 2^20) per dimension for integer points and [0, 1) for floats."""
    dim = points.shape[1]
    out = dict(params)
    if out.get("lam") is None:
        out["lam"] = 3 if dim == 2 else 2
    lo, hi = (0.0, 1.0) if points.dtype.is_floating_point else \
        (0, DEFAULT_ROOT_HI)
    for name, fill in (("root_lo", lo), ("root_hi", hi)):
        if out.get(name) is None:
            out[name] = torch.full((dim,), fill, dtype=points.dtype,
                                   device=points.device)
        out[name] = torch.as_tensor(out[name], device=points.device).to(
            points.dtype)
    return out


def _porth_build(points, mask, *, phi, capacity_rows, root_lo, root_hi,
                 lam, rounds):
    return porth.build(points, root_lo, root_hi, mask, phi=phi, lam=lam,
                       rounds=rounds, capacity_rows=capacity_rows)


def _porth_insert(tree, pts, mask, *, max_overflow_rows):
    mor = min(int(max_overflow_rows), tree.pts.shape[0])
    return porth.insert(tree, pts, mask, max_overflow_rows=mor)


register_backend(Backend(
    name="porth", build=_porth_build, insert=_porth_insert,
    delete=porth.delete, dynamic=True, grow=porth.grow,
    compact=porth.compact, cap_slack=8,
    build_params=("root_lo", "root_hi", "lam", "rounds"),
    insert_params=("max_overflow_rows",),
    defaults=dict(root_lo=None, root_hi=None, lam=None, rounds=5,
                  max_overflow_rows=64),
    resolve=_porth_resolve))


def _spac_build(points, mask, *, phi, capacity_rows, curve, bits,
                coord_bits):
    return spac.build(points, mask, phi=phi, curve=curve, bits=bits,
                      coord_bits=coord_bits, capacity_rows=capacity_rows)


def _spac_insert(tree, pts, mask, *, max_overflow_rows, sort_rows):
    mor = min(int(max_overflow_rows), tree.pts.shape[0])
    return spac.insert(tree, pts, mask, max_overflow_rows=mor,
                       sort_rows=sort_rows)


for _name, _curve, _sort in (("spac-h", "hilbert", False),
                             ("spac-z", "morton", False),
                             ("spac-m", "morton", False),
                             ("cpam-h", "hilbert", True),
                             ("cpam-z", "morton", True)):
    register_backend(Backend(
        name=_name, build=_spac_build, insert=_spac_insert,
        delete=spac.delete, dynamic=True, grow=spac.grow,
        compact=spac.compact, cap_slack=4,
        build_params=("curve", "bits", "coord_bits"),
        insert_params=("max_overflow_rows", "sort_rows"),
        defaults=dict(curve=_curve, bits=16, coord_bits=30,
                      max_overflow_rows=64, sort_rows=_sort)))


def _kd_build(points, mask, *, phi, capacity_rows, max_depth):
    return baselines.kd_build(points, mask, phi=phi, max_depth=max_depth,
                              capacity_rows=capacity_rows)


def _kd_insert(tree, pts, mask, *, capacity_rows, max_depth):
    return baselines.kd_insert(tree, pts, mask, max_depth=max_depth,
                               capacity_rows=capacity_rows)


def _kd_delete(tree, pts, mask, *, capacity_rows, max_depth):
    return baselines.kd_delete(tree, pts, mask, max_depth=max_depth,
                               capacity_rows=capacity_rows)


def _zd_build(points, mask, *, phi, capacity_rows, bits, coord_bits, lam):
    return baselines.zd_build(points, mask, phi=phi, bits=bits,
                              coord_bits=coord_bits, lam=lam,
                              capacity_rows=capacity_rows)


def _zd_insert(tree, pts, mask, *, capacity_rows, bits, coord_bits, lam):
    return baselines.zd_insert(tree, pts, mask, bits=bits,
                               coord_bits=coord_bits, lam=lam,
                               capacity_rows=capacity_rows)


def _zd_delete(tree, pts, mask, *, capacity_rows, bits, coord_bits, lam):
    return baselines.zd_delete(tree, pts, mask, bits=bits,
                               coord_bits=coord_bits, lam=lam,
                               capacity_rows=capacity_rows)


register_backend(Backend(
    name="kd", build=_kd_build, insert=_kd_insert, delete=_kd_delete,
    dynamic=False, cap_slack=4, build_params=("max_depth",),
    insert_params=("max_depth",), delete_params=("max_depth",),
    defaults=dict(max_depth=24)))

register_backend(Backend(
    name="zd", build=_zd_build, insert=_zd_insert, delete=_zd_delete,
    dynamic=False, cap_slack=8, build_params=("bits", "coord_bits", "lam"),
    insert_params=("bits", "coord_bits", "lam"),
    delete_params=("bits", "coord_bits", "lam"),
    defaults=dict(bits=15, coord_bits=20, lam=3)))


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------

class SpatialIndex:
    """Handle over one backend tree; updates return new handles and
    leave the old tree untouched. Construct via :func:`make_index`."""

    def __init__(self, kind: str, tree, *, phi: int, params: dict,
                 donate: bool = False, size_hint: int = 0,
                 rebuild_rows: int = 0, engine: QueryEngine | None = None):
        self.kind = kind
        self._backend = get_backend(kind)
        self._tree = tree
        self.phi = phi
        self._params = params
        self._donate = donate
        # host-side upper bound on live points (rebuild backends size
        # their next rebuild from it without a device read; never
        # decremented, so capacity stays sufficient)
        self._size_hint = size_hint
        self._rebuild_rows = rebuild_rows
        # planning state (flat-scan budget, converged query buffers)
        # rides along across functional updates
        self._engine = engine if engine is not None else QueryEngine()

    def _wrap(self, tree, size_hint=None, rebuild_rows=None) -> \
            "SpatialIndex":
        return SpatialIndex(
            self.kind, tree, phi=self.phi, params=self._params,
            donate=self._donate,
            size_hint=self._size_hint if size_hint is None else size_hint,
            rebuild_rows=(self._rebuild_rows if rebuild_rows is None
                          else rebuild_rows),
            engine=self._engine)

    def _as_tensor(self, x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _prep(self, pts, mask):
        pts = self._as_tensor(pts)
        if mask is None:
            mask = torch.ones(pts.shape[0], dtype=torch.bool,
                              device=self.device)
        else:
            mask = self._as_tensor(mask, torch.bool)
        return pts, mask

    def _run_update(self, op: str, tree, pts, mask, extra=None):
        b = self._backend
        names = b.insert_params if op == "insert" else b.delete_params
        kw = {k: self._params[k] for k in names}
        kw.update(extra or {})
        fn = b.insert if op == "insert" else b.delete
        return fn(tree, pts, mask, **kw)

    # -- introspection -----------------------------------------------------

    @property
    def tree(self):
        """The raw backend tree (escape hatch; prefer the facade)."""
        return self._tree

    @property
    def device(self) -> torch.device:
        return self._tree.pts.device

    @property
    def capacity_rows(self) -> int:
        return self._tree.pts.shape[0]

    @property
    def num_rows(self):
        """Occupied leaf rows (0-d device tensor)."""
        return self._tree.active.sum(dtype=torch.int32)

    @property
    def dim(self) -> int:
        return self._tree.pts.shape[2]

    @property
    def size(self):
        """Live point count (0-d device tensor; ``int()`` it to sync)."""
        return self._tree.size

    @property
    def nbytes(self) -> int:
        """Resident bytes of the tree (metadata only, no device read)."""
        return tree_bytes(self._tree)

    def __len__(self) -> int:
        return int(self.size)

    def view(self) -> queries.LeafView:
        return self._tree.view()

    def block_until_ready(self) -> "SpatialIndex":
        """Wait for the device work queued so far on the tree's device."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return self

    def extract_points(self):
        """All (points, valid) pairs flattened."""
        R, C, dim = self._tree.pts.shape
        ok = (self._tree.valid & self._tree.active[:, None]).reshape(R * C)
        return self._tree.pts.reshape(R * C, dim), ok

    # -- updates -----------------------------------------------------------

    def insert(self, new_pts, new_mask=None) -> "SpatialIndex":
        """Batch insert; grows on overflow, so the result never has
        ``overflowed`` set (reads the flag: one device sync)."""
        pts, mask = self._prep(new_pts, new_mask)
        if not self._backend.dynamic:
            return self._rebuild_insert(pts, mask)
        tree = self._run_update("insert", self._tree, pts, mask)
        if bool(tree.overflowed):
            tree = self._recover_insert(tree, pts, mask)
        return self._wrap(tree)

    def _rebuild_insert(self, pts, mask) -> "SpatialIndex":
        """Insert for rebuild backends: rows from the host-side size
        bound, then a size check, doubling rows on a shortfall (a rebuild
        drops points past row capacity with no flag, and clustered data
        can need far more rows than the heuristic)."""
        b = self._backend
        hint = self._size_hint + pts.shape[0]
        rows = max(self._rebuild_rows, _round_capacity(
            capacity_for(hint, self.phi, b.cap_slack)))
        expected = int(self._tree.size) + int(mask.sum())
        for _ in range(6):
            tree = self._run_update("insert", self._tree, pts, mask,
                                    extra=dict(capacity_rows=rows))
            if int(tree.size) == expected:
                return self._wrap(tree, size_hint=hint, rebuild_rows=rows)
            obs.count("index.rebuild_retry")
            rows = 2 * rows
        raise RuntimeError(f"{self.kind}: insert of {pts.shape[0]} points "
                           f"still overflows at capacity_rows={rows}")

    def _recover_insert(self, failed_tree, pts, mask):
        """The grow -> retry -> compact ladder (inserts are all-or-nothing,
        so the failed tree holds the old contents)."""
        b = self._backend
        off = torch.zeros((), dtype=torch.bool, device=self.device)
        tree = dataclasses.replace(failed_tree, overflowed=off)
        live = int(tree.size) + pts.shape[0]
        need = _round_capacity(capacity_for(live, self.phi, b.cap_slack))
        mor = int(self._params.get("max_overflow_rows", 64))
        recovery = obs.span("index.recover_insert", kind=self.kind).begin()
        for attempt in range(4):
            cap = max(need << attempt, 2 * tree.pts.shape[0])
            obs.count("index.grow" if attempt == 0 else "index.compact")
            tree = (b.grow(tree, cap) if attempt == 0
                    else b.compact(tree, cap))
            mor = min(4 * mor, cap)
            out = self._run_update("insert", tree, pts, mask,
                                   extra=dict(max_overflow_rows=mor))
            if not bool(out.overflowed):
                recovery.set(attempts=attempt + 1, capacity_rows=cap).end()
                return out
            tree = dataclasses.replace(out, overflowed=off)
        recovery.set(failed=True).end()
        raise RuntimeError(f"{self.kind}: insert of {pts.shape[0]} points "
                           f"still overflows at capacity_rows={cap}")

    def insert_unchecked(self, new_pts, new_mask=None) -> "SpatialIndex":
        """Dispatch-only insert for the serving runtime: no host read of
        ``overflowed``, so the call returns once the update is enqueued.
        The handle may carry the sticky flag; the caller checks it at its
        next sync point (:class:`repro_torch.serving.SpatialServer` does
        at ``commit()``). Rebuild backends (kd, zd) take the checked
        :meth:`insert`: their size check reads the device."""
        if not self._backend.dynamic:
            return self.insert(new_pts, new_mask)
        pts, mask = self._prep(new_pts, new_mask)
        return self._wrap(self._run_update("insert", self._tree, pts,
                                           mask))

    def delete(self, del_pts, del_mask=None) -> "SpatialIndex":
        """Batch delete (exact multiset semantics; absent points no-op)."""
        pts, mask = self._prep(del_pts, del_mask)
        if not self._backend.dynamic:
            # removal only shrinks groups, never splits them, so the
            # rebuild fits at the current capacity
            rows = max(self._rebuild_rows, self.capacity_rows)
            tree = self._run_update("delete", self._tree, pts, mask,
                                    extra=dict(capacity_rows=rows))
            return self._wrap(tree, rebuild_rows=rows)
        return self._wrap(self._run_update("delete", self._tree, pts, mask))

    delete_unchecked = delete   # deletes cannot overflow rows

    # -- queries (exact by default; see repro_torch.core.engine) -----------

    @property
    def engine(self) -> QueryEngine:
        return self._engine

    def knn(self, qpts, k: int, *, impl: str = "auto"):
        """Exact batched kNN -> (d2 (Q, k) ascending, flat ids (Q, k)).
        ``impl``: see :data:`repro_torch.core.engine.KNN_IMPLS`."""
        return self._engine.knn(self.view(), self._as_tensor(qpts), k,
                                impl=impl)

    def knn_points(self, qpts, k: int, *, impl: str = "auto"):
        """kNN returning coordinates: (d2, neighbor points, valid)."""
        view = self.view()
        d2, ids = self._engine.knn(view, self._as_tensor(qpts), k,
                                   impl=impl)
        return d2, queries.gather_points(view, ids), ids >= 0

    def range_count(self, lo, hi):
        """Exact batched range count -> counts (Q,)."""
        return self._engine.range_count(self.view(), self._as_tensor(lo),
                                        self._as_tensor(hi))

    def range_list(self, lo, hi):
        """Exact batched range report -> (ids (Q, cap) padded with -1,
        counts (Q,))."""
        return self._engine.range_list(self.view(), self._as_tensor(lo),
                                       self._as_tensor(hi))

    def __repr__(self):
        return (f"SpatialIndex(kind={self.kind!r}, "
                f"capacity_rows={self.capacity_rows}, phi={self.phi}, "
                f"device={self.device})")


def make_index(kind: str, points, mask=None, *, phi: int = 32,
               capacity_rows: int | None = None,
               capacity_points: int | None = None, device=None,
               mesh=None, donate: bool = False, **params) -> SpatialIndex:
    """Build an index of the registered ``kind`` over ``points`` on
    ``device`` (default: the card; pass ``device="cpu"`` for the CPU).

    ``capacity_points`` sizes row capacity for the lifetime maximum of
    live points (default ``len(points)``); ``capacity_rows`` overrides
    the heuristic. Backend options (``curve``, ``bits``, ``coord_bits``,
    ``sort_rows`` for the spac family; ``root_lo``, ``root_hi``, ``lam``,
    ``rounds`` for porth; ``max_overflow_rows`` for both; ``max_depth``
    for kd; ``bits``, ``coord_bits`` and ``lam`` for zd) pass through as
    keywords.
    ``donate=True`` marks a handle whose caller drops old versions after
    each update; :class:`repro_torch.serving.SpatialServer` refuses it.
    """
    if mesh is not None:
        raise NotImplementedError("mesh-sharded indexes are not ported yet")
    backend = get_backend(kind)
    dev = resolve_device(device)
    pts = torch.as_tensor(points, device=dev)
    n = pts.shape[0]
    resolved = dict(backend.defaults)
    unknown = set(params) - set(resolved)
    if unknown:
        raise TypeError(f"{kind}: unknown params {sorted(unknown)}; "
                        f"accepted: {sorted(resolved)}")
    resolved.update(params)
    if backend.resolve is not None:
        resolved = backend.resolve(resolved, pts)
    pts_mask = (torch.ones(n, dtype=torch.bool, device=dev) if mask is None
                else torch.as_tensor(mask, dtype=torch.bool, device=dev))
    expected = n if mask is None else int(pts_mask.sum())
    cap = capacity_rows if capacity_rows is not None else capacity_for(
        capacity_points if capacity_points is not None else n, phi,
        backend.cap_slack)
    build_kw = {k: resolved[k] for k in backend.build_params}
    for _ in range(8):
        tree = backend.build(pts, pts_mask, phi=phi, capacity_rows=cap,
                             **build_kw)
        # rebuild backends have no overflow flag and drop silently; the
        # size check catches both
        if (not bool(getattr(tree, "overflowed", False))
                and int(tree.size) == expected):
            break
        obs.count("index.build_retry")
        # jump at least to the heuristic (explicit caps can be tiny),
        # then keep doubling
        cap = max(2 * cap, capacity_for(expected, phi, backend.cap_slack))
    else:
        raise RuntimeError(f"{kind}: build of {expected} points overflows "
                           f"even at capacity_rows={cap}")
    return SpatialIndex(kind, tree, phi=phi, params=resolved, donate=donate,
                        size_hint=expected,
                        rebuild_rows=0 if backend.dynamic else cap)
