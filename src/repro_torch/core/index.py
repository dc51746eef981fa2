"""Unified ``SpatialIndex`` facade over the ported tree families.

Counterpart of ``repro/core/index.py``: a string-keyed backend registry
plus a thin handle, so callers write

    idx = make_index("spac-h", points, phi=32)     # on the card
    idx = idx.insert(batch)
    d2, ids = idx.knn(queries, k=10)

and never touch ``capacity_rows``, ``overflowed``, ``grow`` or
``compact`` by hand. Row capacity comes from :func:`capacity_for`; an
insert that overflows is recovered through the ladder
``retry -> compact -> grow`` (:meth:`SpatialIndex._recover_insert`),
which differs from the reference's where the reference would double
capacity while the heuristic still covers the live points.

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
rebuilt size, so their updates synchronise). ``make_index(...,
mesh=)`` returns a :class:`DistributedIndex`, the same surface over an
index key-range partitioned over a mesh's lanes
(:mod:`repro_torch.core.distributed`), for the spac curve kinds and
porth.

Entry points run on the card: ``make_index(..., device=None)`` resolves
to CUDA and raises on a host without it (see :mod:`repro_torch.device`).
"""

from __future__ import annotations

import dataclasses
import functools
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
    for capacity recovery and ``overflow_rows(tree, pts, mask)``, the
    rows an insert would split; rebuild backends re-run ``build`` and
    take ``capacity_rows`` as an update param instead."""
    name: str
    build: Callable[..., Any]
    insert: Callable[..., Any]
    delete: Callable[..., Any]
    dynamic: bool
    grow: Callable[..., Any] | None = None
    compact: Callable[..., Any] | None = None
    overflow_rows: Callable[..., Any] | None = None
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
    compact=porth.compact, overflow_rows=porth.overflow_rows, cap_slack=8,
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
        compact=spac.compact, overflow_rows=spac.overflow_rows,
        cap_slack=4,
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
        if obs.costs.enabled():
            # per-plan cost under the reference's update signature
            obs.costs.capture(functools.partial(fn, **kw), (tree, pts, mask),
                              f"update.{self.kind}.{op}.m{pts.shape[0]}"
                              f".d{pts.shape[1]}.r{tree.pts.shape[0]}")
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
        """The retry -> compact -> grow ladder (inserts are all-or-nothing,
        so the failed tree holds the old contents).

        Every retry covers the rows the insert splits: its
        ``max_overflow_rows`` is raised to :attr:`Backend.overflow_rows`
        (one device read an attempt). When :func:`capacity_for` no longer
        covers the live points, capacity grows at once, to the size the
        reference's ladder gives (at least twice the rows, compacting at
        twice that again on a second failure). Otherwise the first retry
        keeps the capacity, the second compacts at it (a compaction that
        does not fit is dropped), and only later ones grow. The
        reference doubles capacity on every failure; with its default 64
        rows an insert of 10^5 points into 10^7 splits thousands, and
        the doublings ran the card out of memory."""
        b = self._backend
        off = torch.zeros((), dtype=torch.bool, device=self.device)
        tree = dataclasses.replace(failed_tree, overflowed=off)
        rows = tree.pts.shape[0]
        live = int(tree.size) + pts.shape[0]
        grow_at = 0 if capacity_for(live, self.phi, b.cap_slack) > rows else 2
        need = _round_capacity(capacity_for(live, self.phi, b.cap_slack))
        mor = int(self._params.get("max_overflow_rows", 64))
        recovery = obs.span("index.recover_insert", kind=self.kind).begin()
        for attempt in range(4):
            cap = (rows if attempt < grow_at else
                   max(need << (attempt - grow_at), 2 * tree.pts.shape[0]))
            if attempt == 0:
                if cap > rows:
                    obs.count("index.grow")
                    tree = b.grow(tree, cap)
            else:
                obs.count("index.compact")
                packed = b.compact(tree, cap)
                # a rebuild that does not fit holds part of the points:
                # keep the tree as it was (the next attempt grows)
                if (bool(packed.overflowed)
                        or int(packed.size) != int(tree.size)):
                    continue
                tree = packed
            mor = min(max(mor, int(b.overflow_rows(tree, pts, mask))), cap)
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
    With ``mesh=`` (:mod:`repro_torch.configs.platform`) the index is
    key-range partitioned over the mesh's lanes and a
    :class:`DistributedIndex` is returned (the lanes' devices place it;
    ``device`` is not used).
    """
    if mesh is not None:
        if donate:
            raise ValueError("donate=True is not supported for "
                             "distributed indexes")
        return DistributedIndex.build(kind, points, mesh, mask=mask,
                                      phi=phi, capacity_rows=capacity_rows,
                                      capacity_points=capacity_points,
                                      **params)
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


# ---------------------------------------------------------------------------
# distributed adapter
# ---------------------------------------------------------------------------

class DistributedIndex:
    """The same surface over an SFC-range-partitioned index on a mesh
    (:mod:`repro_torch.core.distributed`). kNN returns neighbor
    coordinates instead of flat slot ids (ids are shard-local);
    ``range_list`` is not offered distributed."""

    def __init__(self, kind: str, index, mesh, *, phi: int,
                 slack: float = 2.0, build_kw: dict | None = None,
                 engine: QueryEngine | None = None):
        self.kind = kind
        self._index = index
        self.mesh = mesh
        self.phi = phi
        self.slack = slack
        # everything needed to re-shard at a larger capacity (overflow
        # recovery keeps the facade's never-lose-points contract)
        self._build_kw = build_kw or {}
        self._engine = engine if engine is not None else QueryEngine()

    @classmethod
    def build(cls, kind: str, points, mesh, *, mask=None, phi: int = 32,
              capacity_rows: int | None = None,
              capacity_points: int | None = None, slack: float = 2.0,
              n_samples: int = 256, axis: str = "data", **params):
        from . import distributed as D
        backend = get_backend(kind)
        pts = torch.as_tensor(points, device=mesh.devices[0])
        if kind == "porth":
            # the sieve routes by its own prefix keys (Morton codes from
            # midpoint comparisons), so float domains shard exactly
            allowed = ("root_lo", "root_hi", "lam", "rounds")
            resolved = {k: params.pop(k, backend.defaults[k])
                        for k in allowed}
            if params:
                raise TypeError(f"{kind} (distributed): unknown params "
                                f"{sorted(params)}")
            resolved = _porth_resolve(resolved, pts)
            route_kw = dict(
                kind="porth",
                root_lo=tuple(resolved["root_lo"].tolist()),
                root_hi=tuple(resolved["root_hi"].tolist()),
                lam=int(resolved["lam"]), rounds=int(resolved["rounds"]))
        elif "curve" in backend.defaults and \
                not backend.defaults.get("sort_rows"):
            bits = params.pop("bits", backend.defaults["bits"])
            coord_bits = params.pop("coord_bits",
                                    backend.defaults["coord_bits"])
            if params:
                raise TypeError(f"{kind} (distributed): unknown params "
                                f"{sorted(params)}")
            route_kw = dict(kind="spac", curve=backend.defaults["curve"],
                            bits=bits, coord_bits=coord_bits)
        else:
            raise ValueError(
                f"distributed indexes require a mesh-capable kind "
                f"(spac-family or porth), got {kind!r}")
        if capacity_rows is None and capacity_points is not None:
            # per-shard rows for the lifetime maximum, with 2x headroom
            # for routing imbalance
            n_shards = mesh.shape[axis]
            capacity_rows = capacity_for(
                2 * capacity_points // max(n_shards, 1), phi,
                backend.cap_slack)
        build_kw = dict(axis=axis, phi=phi, capacity_rows=capacity_rows,
                        slack=slack, n_samples=n_samples, **route_kw)
        expected = pts.shape[0] if mask is None else int(
            torch.as_tensor(mask, dtype=torch.bool).sum())
        for _ in range(6):
            idx = D.build(pts, mesh, mask, **build_kw)
            # two silent-loss modes: shard-local builds drop past row
            # capacity, and skewed routing overflows the all-to-all slab
            # (reported in `dropped`): escalate whichever bit
            size, dropped = int(D.size(idx)), int(idx.dropped)
            if size == expected:
                break
            if dropped:
                build_kw["slack"] = 2 * build_kw["slack"]
            if size + dropped != expected:
                build_kw["capacity_rows"] = 2 * idx.tree[0].pts.shape[0]
        else:
            raise RuntimeError(
                f"{kind} (distributed): build of {expected} points still "
                f"loses points at capacity_rows="
                f"{build_kw['capacity_rows']}, slack={build_kw['slack']}")
        return cls(kind, idx, mesh, phi=phi, slack=build_kw["slack"],
                   build_kw=build_kw)

    def _wrap(self, idx, slack: float | None = None) -> "DistributedIndex":
        return DistributedIndex(
            self.kind, idx, self.mesh, phi=self.phi,
            slack=self.slack if slack is None else slack,
            build_kw=self._build_kw, engine=self._engine)

    def _lanes(self) -> int:
        return self.mesh.shape[self._build_kw["axis"]]

    # -- introspection -----------------------------------------------------

    @property
    def index(self):
        """The raw :class:`repro_torch.core.distributed.DistIndex`."""
        return self._index

    @property
    def device(self) -> torch.device:
        """Lane 0's device: where answers and counters land."""
        return self.mesh.devices[0]

    @property
    def size(self):
        """Live points over all shards (0-d tensor on lane 0)."""
        from . import distributed as D
        return D.size(self._index)

    def __len__(self) -> int:
        return int(self.size)

    @property
    def dropped(self):
        """Points lost to routing-slab overflow (0 = exact; re-shard with
        a larger ``slack`` if nonzero)."""
        return self._index.dropped

    @property
    def tree(self) -> tuple:
        """The per-lane backend trees (the serving runtime's handle for
        memory accounting; ``overflowed`` is per shard here)."""
        return self._index.tree

    @property
    def overflowed(self):
        """The shards' sticky ``overflowed`` flags, shape (n_shards,), on
        lane 0 (no device read)."""
        return torch.stack([t.overflowed.to(self.device, non_blocking=True)
                            for t in self._index.tree])

    def shard_sizes(self):
        """Per-shard live point counts, shape (n_shards,), on lane 0."""
        from . import distributed as D
        return D.shard_sizes(self._index)

    @property
    def nbytes(self) -> int:
        """Resident bytes across all shards (metadata only)."""
        return (tree_bytes(self._index.tree)
                + self._index.splitters.nbytes + self._index.dropped.nbytes)

    def block_until_ready(self) -> "DistributedIndex":
        """Wait for the work queued so far on every lane's device."""
        for dev in dict.fromkeys(self.mesh.devices):
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
        return self

    def extract_points(self):
        """All (points, valid) pairs of every shard, flattened on lane 0."""
        lane0 = self.device
        pts, ok = [], []
        for t in self._index.tree:
            R, C, dim = t.pts.shape
            pts.append(t.pts.reshape(R * C, dim).to(lane0))
            ok.append((t.valid & t.active[:, None]).reshape(R * C).to(lane0))
        return torch.cat(pts), torch.cat(ok)

    # -- updates -----------------------------------------------------------

    def _prep(self, pts, mask):
        pts = torch.as_tensor(pts, device=self.device)
        if mask is not None:
            mask = torch.as_tensor(mask, dtype=torch.bool, device=self.device)
        return pts, mask

    def insert(self, pts, mask=None) -> "DistributedIndex":
        """Batch insert. Two shard-level failures are recovered here, so
        callers never lose points: a shard whose rows fill up keeps its
        old contents and raises ``overflowed`` (all-or-nothing), and a
        skewed batch can overflow the routing slab (``dropped`` grows).
        Either way the pre-insert snapshot plus the batch is re-sharded
        at doubled per-shard capacity / escalated slack."""
        from . import distributed as D
        pts, mask = self._prep(pts, mask)
        base = int(self._index.dropped)
        slack = self.slack
        for _ in range(3):
            out = self._wrap(D.insert(self._index, pts, self.mesh, mask,
                                      slack=slack), slack)
            if bool(out.overflowed.any()):
                break               # shard rows full: re-shard below
            if int(out.dropped) == base:
                return out          # keep the slack that worked
            # routing slab too tight: a fully-skewed batch (all entries
            # to one shard) needs slack ~ n_shards, so jump there
            slack = max(2 * slack, self._lanes())
        old_pts, old_ok = self.extract_points()
        batch_ok = (torch.ones(pts.shape[0], dtype=torch.bool,
                               device=self.device) if mask is None else mask)
        all_pts = torch.cat([old_pts, pts.to(old_pts.dtype)])
        all_ok = torch.cat([old_ok, batch_ok])
        kw = self._build_kw
        # routing-key params pass through per kind; the classmethod
        # retries at doubling capacity until the full multiset fits
        extra = {k: kw[k] for k in ("bits", "coord_bits", "root_lo",
                                    "root_hi", "lam", "rounds") if k in kw}
        return DistributedIndex.build(
            self.kind, all_pts, self.mesh, mask=all_ok, phi=self.phi,
            capacity_rows=2 * self._index.tree[0].pts.shape[0],
            slack=slack, n_samples=kw["n_samples"], axis=kw["axis"],
            **extra)

    def insert_unchecked(self, pts, mask=None) -> "DistributedIndex":
        """Dispatch-only insert for the serving runtime: no host read of
        ``dropped`` or of the per-shard ``overflowed`` flags, so the call
        returns once the update is queued. Both signals are sticky; the
        caller checks them at its next sync point
        (:class:`repro_torch.serving.SpatialServer` at eviction and
        ``commit()``) and replays from the last good version."""
        from . import distributed as D
        pts, mask = self._prep(pts, mask)
        return self._wrap(D.insert(self._index, pts, self.mesh, mask,
                                   slack=self.slack))

    def delete_unchecked(self, pts, mask=None) -> "DistributedIndex":
        """Dispatch-only delete: skips the host read of ``dropped`` (a
        dropped delete entry leaves a point alive; caught at commit). The
        shard-local deletes read one scalar each."""
        from . import distributed as D
        pts, mask = self._prep(pts, mask)
        return self._wrap(D.delete(self._index, pts, self.mesh, mask,
                                   slack=self.slack))

    def delete(self, pts, mask=None) -> "DistributedIndex":
        """Batch delete. A skewed batch can overflow the routing slab and
        leave entries undeleted: retry from the (untouched) pre-delete
        index with escalated slack until nothing is dropped."""
        from . import distributed as D
        pts, mask = self._prep(pts, mask)
        base = int(self._index.dropped)
        slack = self.slack
        for _ in range(5):
            out = D.delete(self._index, pts, self.mesh, mask, slack=slack)
            if int(out.dropped) == base:
                return self._wrap(out, slack)
            # worst case (fully-skewed batch) needs slack ~ n_shards
            slack = max(2 * slack, self._lanes())
        raise RuntimeError(
            f"{self.kind} (distributed): delete batch still overflows "
            f"the routing slab at slack={slack}")

    # -- queries -----------------------------------------------------------

    @property
    def engine(self) -> QueryEngine:
        return self._engine

    def knn(self, qpts, k: int, *, impl: str = "auto"):
        """Exact distributed kNN -> (d2, neighbor points, valid): the
        engine routes each shard's query and merges the top-k of the
        per-shard top-k."""
        return self._engine.knn_dist(
            self._index, torch.as_tensor(qpts, device=self.device), k,
            self.mesh, impl=impl)

    knn_points = knn

    def range_count(self, lo, hi):
        """Exact distributed range count -> counts (Q,)."""
        return self._engine.range_count_dist(
            self._index, torch.as_tensor(lo, device=self.device),
            torch.as_tensor(hi, device=self.device), self.mesh)

    def __repr__(self):
        return (f"DistributedIndex(kind={self.kind!r}, "
                f"mesh={dict(self.mesh.shape)}, phi={self.phi}, "
                f"device={self.device})")
