"""Distributed dynamic spatial index: the paper's index key-range
partitioned over the lanes of a mesh.

Counterpart of ``repro/core/distributed.py``, function by function. The
reference runs one ``shard_map`` program over a device mesh; the port
keeps its single-controller shape (:mod:`repro_torch.configs.platform`):
one process owns every shard, a shard lives on its lane's device, and
the three collectives below move per-lane blocks between lanes.

* splitters -- each lane samples its local routing keys; the samples are
  all-gathered and quantile splitters define the per-shard key ranges.
  The routing key is the backend's SFC code, carried in ``int64``: the
  spac family encodes its curve (the Morton kernel for ``spac-z``), porth
  uses the sieve's prefix keys (:func:`repro_torch.core.porth.point_keys`).
* routing -- an update computes keys, ``searchsorted`` against the
  splitters, packs rows into fixed-capacity per-destination slabs and
  exchanges them with ONE all-to-all; rows past a slab's capacity are
  counted in ``dropped`` (the caller re-shards with a larger slack).
* local index -- each lane owns an independent SPaC-tree or P-Orth tree
  over its key range, built and updated by the port's ``spac`` and
  ``porth`` functions (bit-equal to the reference's ``*_impl`` ones).
* queries -- kNN runs on every shard and a merge takes the top-k of the
  per-shard top-k (exact: shards partition the point set); range counts
  are summed across shards.

Placement follows ``P(axis)`` on dim 0: after :func:`_pad_rows`, lane i
takes rows ``[i*m/S, (i+1)*m/S)``, and the all-to-all delivers to each
lane in (source lane, slot) order, so splitters and trees are the
reference's.

The reference's ``lru_cache`` closure factories are plan caches here,
keyed the same way: a miss counts ``dist.plan_miss``; the first call of
a plan at a new input signature (shapes and dtypes, the counterpart of a
jit trace) counts ``dist.update_trace`` for updates and, for queries,
the engine's trace counter (``engine.trace`` and
:func:`repro_torch.core.engine.trace_count`), so the serving runtime's
retrace bound holds across the merge.

An update is sync-free on the host except a delete, which reads one
scalar per lane (the shard-local delete's band rounds, see
:func:`repro_torch.core.spac.delete`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from .. import obs
from ..kernels.frontier import ops as frontier_ops
from ..kernels.knn import ops as knn_ops
from . import engine as _engine
from . import porth, queries, spac
from .leafstore import BIG, group_occurrence

CODE_MAX = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class DistIndex:
    tree: tuple        # one backend tree per lane
    splitters: Any     # (n_shards - 1,) int64 on lane 0 (codes < 2^32)
    dropped: Any       # () int32 on lane 0: points lost to slab overflow
    axis: str = "data"
    kind: str = "spac"          # routing-key family: "spac" | "porth"
    # hashable routing-key params (spac: curve/bits/coord_bits; porth:
    # root_lo/root_hi tuples + lam/rounds), the plans' cache key
    ckey: tuple = (("bits", 16), ("coord_bits", 30),
                   ("curve", "hilbert"))


# ---------------------------------------------------------------- collectives

def all_gather(blocks, mesh) -> list:
    """Every lane's block, concatenated in lane order, on every lane."""
    return [torch.cat([b.to(lane, non_blocking=True) for b in blocks])
            for lane in mesh.devices]


def all_to_all(blocks, mesh) -> list:
    """``blocks[src]`` is ``(S, cap, ...)`` with row ``dst`` bound for lane
    ``dst``; lane ``dst`` receives ``(S*cap, ...)`` in (source lane, slot)
    order."""
    return [torch.cat([b[dst].to(lane, non_blocking=True) for b in blocks])
            for dst, lane in enumerate(mesh.devices)]


def psum(values):
    """Sum of one value per lane, on the first lane's device (dtype
    kept)."""
    lane0 = values[0].device
    return torch.stack([v.to(lane0, non_blocking=True)
                        for v in values]).sum(0, dtype=values[0].dtype)


def _split_rows(x, mesh) -> list:
    """``P(axis)`` on dim 0: lane i takes rows ``[i*m/S, (i+1)*m/S)``."""
    m = x.shape[0] // mesh.size
    return [x[i * m:(i + 1) * m].to(lane, non_blocking=True)
            for i, lane in enumerate(mesh.devices)]


# ---------------------------------------------------------------- routing

@functools.lru_cache(maxsize=None)
def _root(values: tuple, dtype, device):
    """porth's root corner as a tensor on ``device`` (made once: a host
    value copied to the card synchronises)."""
    return torch.tensor(values, dtype=dtype, device=device)


def _codes(pts, kind: str, kw: dict):
    """Routing key of each point (int64, < 2^32): the backend's SFC
    spelling."""
    if kind == "porth":
        return porth.point_keys(
            pts, _root(kw["root_lo"], pts.dtype, pts.device),
            _root(kw["root_hi"], pts.dtype, pts.device), lam=kw["lam"],
            rounds=kw["rounds"])
    return spac._encode(pts.to(torch.int32), kw["curve"], kw["bits"],
                        kw["coord_bits"])


def _coerce(pts, kind: str):
    """spac shards store int32 coordinates; porth keeps the caller's
    dtype."""
    return pts if kind == "porth" else pts.to(torch.int32)


def _sample_splitters(codes, masks, mesh, n_shards: int,
                      n_samples: int = 256) -> list:
    """Deterministic quantile splitters from sorted local samples, one
    (replicated) copy per lane.

    Each lane contributes exactly ``n_samples`` codes drawn evenly (with
    replacement when it holds fewer valid rows) from the *valid* prefix
    of its locally sorted codes (the reference's fix: CODE_MAX padding
    would push the top quantiles to CODE_MAX and leave the last shards
    empty)."""
    local = []
    for c, m in zip(codes, masks):
        srt = torch.sort(torch.where(m, c, CODE_MAX)).values
        v = m.sum().clamp(min=1)
        pos = (torch.arange(n_samples, device=c.device) * v) // n_samples
        local.append(srt[pos])
    out = []
    for allv in all_gather(local, mesh):
        allv = torch.sort(allv).values
        total = allv.shape[0]
        idx = (torch.arange(1, n_shards, device=allv.device) * total) \
            // n_shards
        out.append(allv[idx])
    return out


def _pack(pts, mask, bucket, n_shards: int, cap: int):
    """Pack rows into per-destination slabs ``(n_shards*cap, ...)``; rows
    past a slab's ``cap`` go to a dump row that is cut off. Returns the
    slabs and the count of dropped rows (int32)."""
    n, dim = pts.shape
    key = torch.where(mask, bucket, n_shards)
    perm = torch.argsort(key, stable=True)
    sb, sp, sm = key[perm], pts[perm], mask[perm]
    occ = group_occurrence(sb)
    keep = sm & (occ < cap)
    slot = torch.where(keep, sb * cap + occ, n_shards * cap).long()
    send_pts = torch.zeros((n_shards * cap + 1, dim), dtype=pts.dtype,
                           device=pts.device).index_put_((slot,), sp)
    send_mask = torch.zeros(n_shards * cap + 1, dtype=torch.bool,
                            device=pts.device).index_put_((slot,), keep)
    return (send_pts[:-1], send_mask[:-1],
            (sm & ~keep).sum(dtype=torch.int32))


def _route_exchange(pts, masks, splitters, mesh, n_shards: int, cap: int,
                    kind: str, kw: dict):
    """Route each lane's rows to the shard owning their key range: one
    all-to-all of the packed slabs. Returns the received rows and masks
    per lane and the total dropped rows (on lane 0)."""
    send_p, send_m, dropped = [], [], []
    for p, m, s in zip(pts, masks, splitters):
        bucket = torch.searchsorted(s, _codes(p, kind, kw),
                                    right=True).to(torch.int32)
        sp, sm, d = _pack(_coerce(p, kind), m, bucket, n_shards, cap)
        send_p.append(sp.view(n_shards, cap, -1))
        send_m.append(sm.view(n_shards, cap))
        dropped.append(d)
    return all_to_all(send_p, mesh), all_to_all(send_m, mesh), psum(dropped)


def _pad_rows(pts, mask, n_shards: int):
    """Pad the leading (sharded) dim to a multiple of the shard count --
    shape metadata only, so dispatch paths stay host-sync-free."""
    m = pts.shape[0]
    if mask is None:
        mask = torch.ones(m, dtype=torch.bool, device=pts.device)
    pad = (-m) % n_shards
    if pad:
        pts = torch.cat([pts, pts.new_zeros((pad, pts.shape[1]))])
        mask = torch.cat([mask, mask.new_zeros(pad)])
    return pts, mask


# ---------------------------------------------------------------- plans
#
# Each reference closure factory is a plan cache keyed on the static
# routing and shape parameters. A plan counts its "traces": the first
# call at each input signature.

def _signature(x):
    """Shapes and dtypes of a plan's inputs (trees by their points)."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), str(x.dtype)
    if isinstance(x, (tuple, list)):
        return tuple(_signature(v) for v in x)
    if dataclasses.is_dataclass(x):
        return type(x).__name__, _signature(x.pts)
    return x


class _Plan:
    """A cached distributed program; ``on_trace`` runs at the first call
    with each input signature."""

    def __init__(self, run, on_trace):
        self._run, self._on_trace, self._seen = run, on_trace, set()

    def __call__(self, *args):
        sig = _signature(args)
        if sig not in self._seen:
            self._seen.add(sig)
            self._on_trace()
        return self._run(*args)


def _update_traced() -> None:
    obs.count("dist.update_trace")


def _local_build(rp, rm, kind: str, kw: dict, phi: int, capacity_rows: int):
    if kind == "porth":
        return porth.build(
            rp, _root(kw["root_lo"], rp.dtype, rp.device),
            _root(kw["root_hi"], rp.dtype, rp.device), rm, phi=phi,
            lam=kw["lam"], rounds=kw["rounds"], capacity_rows=capacity_rows)
    return spac.build(rp, rm, phi=phi, curve=kw["curve"], bits=kw["bits"],
                      coord_bits=kw["coord_bits"],
                      capacity_rows=capacity_rows)


@functools.lru_cache(maxsize=None)
def _build_plan(mesh, axis: str, n_shards: int, cap: int, kind: str,
                phi: int, capacity_rows: int, n_samples: int, ckey: tuple):
    obs.count("dist.plan_miss")
    kw = dict(ckey)

    def run(points, mask):
        pts, msk = _split_rows(points, mesh), _split_rows(mask, mesh)
        codes = [_codes(p, kind, kw) for p in pts]
        splitters = _sample_splitters(codes, msk, mesh, n_shards, n_samples)
        rp, rm, dropped = _route_exchange(pts, msk, splitters, mesh,
                                          n_shards, cap, kind, kw)
        tree = tuple(_local_build(p, m, kind, kw, phi, capacity_rows)
                     for p, m in zip(rp, rm))
        return tree, splitters[0], dropped

    return _Plan(run, _update_traced)


@functools.lru_cache(maxsize=None)
def _update_plan(mesh, axis: str, n_shards: int, cap: int, kind: str,
                 op: str, mor: int, ckey: tuple):
    obs.count("dist.plan_miss")
    kw = dict(ckey)
    mod = porth if kind == "porth" else spac

    def run(trees, points, mask, splitters):
        pts, msk = _split_rows(points, mesh), _split_rows(mask, mesh)
        spl = [splitters.to(lane, non_blocking=True)
               for lane in mesh.devices]
        rp, rm, dropped = _route_exchange(pts, msk, spl, mesh, n_shards,
                                          cap, kind, kw)
        if op == "insert":
            tree = tuple(mod.insert(t, p, m, max_overflow_rows=mor)
                         for t, p, m in zip(trees, rp, rm))
        else:
            tree = tuple(mod.delete(t, p, m)
                         for t, p, m in zip(trees, rp, rm))
        return tree, dropped

    return _Plan(run, _update_traced)


# Queries need no routing: every shard answers over its whole subtree
# (queries go to every lane) and the merge runs on lane 0.

@functools.lru_cache(maxsize=None)
def _knn_plan(k: int, impl: str, kernel: str, chunk: int):
    obs.count("dist.plan_miss")

    def one(tree, q):
        view = tree.view()
        q = q.to(tree.pts.device, non_blocking=True)
        if impl == "frontier":
            d2, ids = queries.knn_impl(view, q, k, chunk)
        elif impl == "frontier-kernel":
            d2, ids = frontier_ops.knn_frontier_impl(
                view.pts, view.valid, view.active, view.bbox_lo,
                view.bbox_hi, q, k=k, impl=kernel)
        else:
            flat_pts, flat_ok = queries.flatten_view(view)
            d2, ids = knn_ops.knn_bruteforce(q, flat_pts, flat_ok, k=k,
                                             impl=kernel)
        d2, ids = _engine.canonical_knn(d2, ids)
        return torch.where(ids >= 0, d2, BIG), queries.gather_points(view,
                                                                     ids)

    def run(trees, q):
        lane0 = trees[0].pts.device
        outs = [one(t, q) for t in trees]
        all_d2 = torch.stack([d.to(lane0, non_blocking=True)
                              for d, _ in outs])            # (S, Q, k)
        all_pts = torch.stack([p.to(lane0, non_blocking=True)
                               for _, p in outs])           # (S, Q, k, D)
        S, qn, _ = all_d2.shape
        cat_d2 = all_d2.transpose(0, 1).reshape(qn, S * k)
        cat_pts = all_pts.transpose(0, 1).reshape(qn, S * k, -1)
        # the first k of a stable ascending sort: lax.top_k's entries
        # (ties to the lowest index)
        sel = torch.argsort(cat_d2, dim=1, stable=True)[:, :k]
        d2 = cat_d2.gather(1, sel)
        best = cat_pts.gather(
            1, sel[..., None].expand(-1, -1, cat_pts.shape[-1]))
        return d2, best, d2 < BIG

    return _Plan(run, _engine._traced)


@functools.lru_cache(maxsize=None)
def _range_count_plan(max_rows: int):
    obs.count("dist.plan_miss")

    def run(trees, lo, hi):
        cnt, trunc = zip(*(queries.range_count_impl(
            t.view(), lo.to(t.pts.device, non_blocking=True),
            hi.to(t.pts.device, non_blocking=True), max_rows)
            for t in trees))
        return psum(cnt), psum([t.to(torch.int32) for t in trunc]) > 0

    return _Plan(run, _engine._traced)


# ----------------------------------------------------------------- build

def build(points, mesh, mask=None, *, axis: str = "data", phi: int = 32,
          kind: str = "spac", curve: str = "hilbert", bits: int = 16,
          coord_bits: int = 30, root_lo=None, root_hi=None, lam: int = 3,
          rounds: int = 5, capacity_rows: int | None = None,
          slack: float = 2.0, n_samples: int = 256) -> DistIndex:
    """points: (N, dim) on the first lane's device (ragged N is padded to
    the shard count). Returns a DistIndex with one local tree per lane.

    ``kind="spac"`` routes by curve code (``curve``/``bits``/
    ``coord_bits``); ``kind="porth"`` routes by sieve prefix key
    (``root_lo``/``root_hi`` domain tuples + ``lam``/``rounds``)."""
    n, dim = points.shape
    n_shards = mesh.shape[axis]
    lane0 = mesh.devices[0]
    points = torch.as_tensor(points, device=lane0)
    if mask is not None:
        mask = torch.as_tensor(mask, dtype=torch.bool, device=lane0)
    points, mask = _pad_rows(points, mask, n_shards)
    n_local = n // max(n_shards, 1)
    cap = int(n_local * slack / n_shards) + 8
    if capacity_rows is None:
        capacity_rows = max(4 * ((n_shards * cap + phi - 1) // phi), 8)
    if kind == "porth":
        if root_lo is None or root_hi is None:
            raise ValueError("kind='porth' needs root_lo/root_hi")
        ckey = (("lam", int(lam)), ("root_hi", _as_tuple(root_hi)),
                ("root_lo", _as_tuple(root_lo)), ("rounds", int(rounds)))
    else:
        ckey = (("bits", int(bits)), ("coord_bits", int(coord_bits)),
                ("curve", curve))
    plan = _build_plan(mesh, axis, n_shards, cap, kind, phi,
                       int(capacity_rows), n_samples, ckey)
    tree, splitters, dropped = plan(points, mask)
    return DistIndex(tree=tree, splitters=splitters, dropped=dropped,
                     axis=axis, kind=kind, ckey=ckey)


def _as_tuple(x) -> tuple:
    """A root corner as a hashable tuple of Python numbers."""
    if isinstance(x, torch.Tensor):
        x = x.cpu()
    return tuple(np.asarray(x).tolist())


# --------------------------------------------------------------- updates

def _update(index: DistIndex, pts, mask, mesh, op: str, slack: float):
    axis = index.axis
    n_shards = mesh.shape[axis]
    lane0 = mesh.devices[0]
    pts = torch.as_tensor(pts, device=lane0)
    if mask is not None:
        mask = torch.as_tensor(mask, dtype=torch.bool, device=lane0)
    pts, mask = _pad_rows(pts, mask, n_shards)
    m = pts.shape[0]
    cap = int((m // n_shards) * slack / n_shards) + 8
    R = index.tree[0].pts.shape[0]
    plan = _update_plan(mesh, axis, n_shards, cap, index.kind, op,
                        min(64, R), index.ckey)
    tree, dropped = plan(index.tree, pts, mask, index.splitters)
    return dataclasses.replace(index, tree=tree,
                               dropped=index.dropped + dropped)


def insert(index: DistIndex, pts, mesh, mask=None, *, slack: float = 2.0):
    return _update(index, pts, mask, mesh, "insert", slack)


def delete(index: DistIndex, pts, mesh, mask=None, *, slack: float = 2.0):
    return _update(index, pts, mask, mesh, "delete", slack)


# --------------------------------------------------------------- queries

def knn(index: DistIndex, qpts, k: int, mesh, chunk: int = 8,
        impl: str = "frontier", kernel: str = "cuda"):
    """Exact distributed kNN. Returns (d2 (Q, k) ascending, points
    (Q, k, dim), valid (Q, k)) on lane 0.

    ``impl="frontier"`` runs the chunked frontier traversal per shard;
    ``impl="frontier-kernel"`` the frontier kernel; ``impl="flat"`` the
    brute-force scan (``kernel``: ``cuda`` or its ``plain`` version; CPU
    tensors take the plain version). ``mesh`` is accepted for symmetry
    with the update path: the trees' own devices place the work."""
    del mesh
    return _knn_plan(int(k), impl, kernel, int(chunk))(index.tree, qpts)


def range_count(index: DistIndex, lo, hi, mesh, max_rows: int = 128):
    """Exact distributed range count: per-shard count + global sum ->
    (counts (Q,), truncated (Q,))."""
    del mesh
    return _range_count_plan(int(max_rows))(index.tree, lo, hi)


def size(index: DistIndex):
    """Live points over all shards (0-d tensor on lane 0)."""
    return psum([t.size for t in index.tree])


def shard_sizes(index: DistIndex):
    """Per-shard live point counts, shape (n_shards,), on lane 0 (no
    device read)."""
    lane0 = index.tree[0].pts.device
    return torch.stack([t.size.to(lane0, non_blocking=True)
                        for t in index.tree])
