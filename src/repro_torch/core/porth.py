"""P-Orth tree: the paper's SFC-free parallel orth-tree (Sec. 3).

Counterpart of ``repro/core/porth.py``, field for field. Construction
sieves points through a lambda-level skeleton per round: the bucket of a
point is computed by lambda * D **coordinate comparisons against cell
midpoints** (never from an encoded code, so float coordinates work too),
all active groups split at once, and groups of at most ``phi`` points
stop and become leaf rows. The prefix keys that fall out of the
comparisons are the directory's sort keys.

Each sieve round is one stable counting sort by bucket inside every
splitting group (:func:`repro_torch.kernels.sieve.ops.segmented_partition`,
the sieve kernel on the card) in place of the reference's stable argsort
of the whole key array. The two orders are the same: the round's input
is sorted by key with each group contiguous, cells are disjoint, and a
new key only adds bucket bits below its group's prefix.

Keys are carried in ``int64`` (``KEY_MAX = 0xFFFFFFFF`` keeps the
reference's ``uint32`` order; where a reference sum wraps past it, the
port masks to 32 bits). :meth:`POrthTree.from_numpy` and
:meth:`POrthTree.to_numpy` convert to and from the reference's fields.
Updates are functional and fixed-shape; insert never reads the device
from the host. Delete reads one scalar per call: the number of
directory-band rounds its walk needs.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..kernels.sieve import ops as sieve_ops
from ..kernels.sieve import ref as sieve_ref
from ..kernels.sieve.ref import midpoint as _midpoint
from .leafstore import (_add_drop, _big_for, _set_rows_drop,
                        append_unsorted, compact_rows, ranked_delete,
                        row_bbox_from_slots, run_first, scatter_to_rows,
                        segment_bbox, take_k_where)
from .queries import LeafView

KEY_MAX = 0xFFFFFFFF
_U32 = 0xFFFFFFFF

FIELDS = ("pts", "valid", "count", "active", "bbox_lo", "bbox_hi",
          "cell_lo", "cell_hi", "cell_key", "cell_depth", "order",
          "num_rows", "overflowed", "root_lo", "root_hi")
_ROW_FIELDS = FIELDS[:10]
_KEY_FIELDS = ("cell_key",)


@dataclasses.dataclass(frozen=True)
class POrthTree:
    pts: Any         # (R, C, D)
    valid: Any       # (R, C) bool
    count: Any       # (R,) int32
    active: Any      # (R,) bool
    bbox_lo: Any     # (R, D) tight point bbox
    bbox_hi: Any     # (R, D)
    cell_lo: Any     # (R, D) orth cell region
    cell_hi: Any     # (R, D)
    cell_key: Any    # (R,) int64 (< 2^32) -- lo-corner prefix key
    cell_depth: Any  # (R,) int32 -- levels of splitting applied
    order: Any       # (R,) int32 rows sorted by cell_key
    num_rows: Any    # () int32
    overflowed: Any  # () bool
    root_lo: Any     # (D,)
    root_hi: Any     # (D,)
    phi: int = 32
    lam: int = 3     # paper: 3 levels/round in 2D, 2 in 3D
    rounds: int = 5  # total depth = lam * rounds; lam*rounds*D <= 31

    @property
    def capacity_rows(self) -> int:
        return self.pts.shape[0]

    @property
    def row_capacity(self) -> int:
        return self.pts.shape[1]

    @property
    def dim(self) -> int:
        return self.pts.shape[2]

    @property
    def device(self) -> torch.device:
        return self.pts.device

    @property
    def total_depth(self) -> int:
        return self.lam * self.rounds

    @property
    def key_bits(self) -> int:
        return self.total_depth * self.dim

    def view(self) -> LeafView:
        return LeafView(self.pts, self.valid, self.active, self.bbox_lo,
                        self.bbox_hi)

    @property
    def size(self):
        """Live points (0-d device tensor)."""
        return torch.where(self.active, self.count, 0).sum()

    @classmethod
    def from_numpy(cls, fields: dict, meta: dict, device) -> "POrthTree":
        """A tree from the reference's fields as numpy arrays (``uint32``
        keys become ``int64``) and its static ``meta`` (phi, lam,
        rounds)."""
        arrays = {}
        for name in FIELDS:
            a = np.asarray(fields[name])
            if name in _KEY_FIELDS:
                a = a.astype(np.int64)
            arrays[name] = torch.tensor(a, device=device)   # a copy
        return cls(**arrays, **meta)

    def to_numpy(self) -> dict:
        """The tree's fields as numpy arrays in the reference's dtypes."""
        out = {name: getattr(self, name).cpu().numpy() for name in FIELDS}
        for name in _KEY_FIELDS:
            out[name] = out[name].astype(np.uint32)
        return out

    @property
    def meta(self) -> dict:
        return dict(phi=self.phi, lam=self.lam, rounds=self.rounds)


# ---------------------------------------------------------------------------
# sieve machinery
# ---------------------------------------------------------------------------

def _split_lambda_levels(pts, lo, hi, lam: int, dim: int):
    """The lambda-level bucket of each point inside its cell by midpoint
    comparisons. Returns (bucket (N,) int64, lo', hi')."""
    bucket, lo, hi = sieve_ref.split_levels(pts, lo, hi, lam=lam)
    return bucket.long(), lo, hi


def _group_stats(sorted_key, ok):
    """Per-point stats over contiguous equal-key runs of a sorted array:
    (gid, cnt, pos) -- run index, valid points in the run, position in
    the run (invalid points sort to the tail as their own run)."""
    n = sorted_key.shape[0]
    dev = sorted_key.device
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    change = torch.ones(n, dtype=torch.bool, device=dev)
    change[1:] = sorted_key[1:] != sorted_key[:-1]
    gid = torch.cumsum(change, 0, dtype=torch.int32) - 1
    per_gid = torch.zeros(n, dtype=torch.int32, device=dev)
    per_gid.index_add_(0, gid.long(), ok.int())
    return gid, per_gid[gid.long()], idx - run_first(change)


def _gather(perm, *arrays):
    return tuple(a[perm] for a in arrays)


def _sieve_rounds(pts, ok, lo, hi, key, depth, phi: int, lam: int,
                  rounds: int, total_depth: int, key_bits: int):
    """Run up to ``rounds`` sieve rounds. Points whose group is <= phi
    (or whose depth is exhausted) stop. Returns the final sorted
    per-point state."""
    n, dim = pts.shape
    idx = torch.arange(n, dtype=torch.int32, device=pts.device)
    n_chunks = sieve_ops.max_chunks(n, phi)

    # initial sort so groups (seeded cells) are contiguous
    skey = torch.where(ok, key, KEY_MAX)
    perm = torch.argsort(skey, stable=True)
    pts, ok, lo, hi, key, depth, skey = _gather(
        perm, pts, ok, lo, hi, key, depth, skey)

    for _ in range(rounds):
        _, cnt, pos = _group_stats(skey, ok)
        act = ok & (cnt > phi) & (depth + lam <= total_depth)
        dest, bucket, lo, hi = sieve_ops.segmented_partition(
            pts, lo, hi, idx - pos, act, lam=lam, n_chunks=n_chunks)
        shift = torch.clamp(key_bits - (depth + lam) * dim, min=0)
        key = torch.where(act, key | (bucket.long() << shift), key)
        depth = torch.where(act, depth + lam, depth)
        perm = torch.empty_like(dest).scatter_(0, dest.long(), idx).long()
        pts, ok, lo, hi, key, depth = _gather(perm, pts, ok, lo, hi, key,
                                              depth)
        skey = torch.where(ok, key, KEY_MAX)
    return pts, ok, lo, hi, key, depth


def _finalize_rows(tree_arrays, pts, ok, lo, hi, key, depth, phi: int,
                   freelist_ids):
    """Chunk sorted sieve output into leaf rows of phi allocated from
    ``freelist_ids`` (padded with -1). Returns updated row arrays and
    can_alloc."""
    R = tree_arrays["pts"].shape[0]
    n = pts.shape[0]
    NR = freelist_ids.shape[0]
    dev = pts.device

    gid, cnt, pos = _group_stats(torch.where(ok, key, KEY_MAX), ok)
    rows_per_gid = (cnt + phi - 1) // phi
    change = torch.ones(n, dtype=torch.bool, device=dev)
    change[1:] = gid[1:] != gid[:-1]
    per_group = torch.where(change, rows_per_gid, 0)
    offset_incl = torch.cumsum(per_group, 0, dtype=torch.int32)
    group_offset = (offset_incl - per_group)[torch.searchsorted(gid, gid)]
    local = group_offset + pos // phi
    slot = pos % phi
    in_new = ok & (local < NR)
    dest = torch.where(
        in_new,
        freelist_ids.clamp(min=0)[local.clamp(0, NR - 1).long()], R)
    need = torch.where(ok, local + 1, 0)
    rows_needed = torch.cat([need, need.new_zeros(1)]).max()
    can_alloc = rows_needed <= (freelist_ids >= 0).sum(dtype=torch.int32)
    dest = torch.where(can_alloc, dest, R)

    a = dict(tree_arrays)
    a["pts"] = scatter_to_rows(a["pts"], dest, slot, pts, in_new)
    a["valid"] = scatter_to_rows(
        a["valid"], dest, slot,
        torch.ones(n, dtype=torch.bool, device=dev), in_new)
    ncount = _add_drop(R, dest, torch.ones(n, dtype=torch.bool, device=dev))
    newly = ncount > 0
    a["count"] = torch.where(newly, ncount, a["count"])
    a["active"] = a["active"] | newly
    nlo, nhi = segment_bbox(pts, torch.where(in_new, dest, R), in_new, R)
    a["bbox_lo"] = torch.where(newly[:, None], nlo, a["bbox_lo"])
    a["bbox_hi"] = torch.where(newly[:, None], nhi, a["bbox_hi"])
    # row leader (first point of each row) carries the cell metadata
    ldest = torch.where(in_new & (slot == 0), dest, R)
    a["cell_lo"] = _set_rows_drop(a["cell_lo"], ldest, lo)
    a["cell_hi"] = _set_rows_drop(a["cell_hi"], ldest, hi)
    a["cell_key"] = _set_rows_drop(a["cell_key"], ldest, key)
    a["cell_depth"] = _set_rows_drop(a["cell_depth"], ldest, depth)
    return a, can_alloc


def _arrays(tree: POrthTree) -> dict:
    return {f: getattr(tree, f) for f in _ROW_FIELDS}


def _rebuild_order(active, cell_key):
    key = torch.where(active, cell_key, KEY_MAX)
    return (torch.argsort(key, stable=True).int(),
            active.sum(dtype=torch.int32))


def _select(ok, new: POrthTree, old: POrthTree) -> POrthTree:
    """Every field from ``new`` where ``ok`` (a 0-d bool), else from
    ``old`` (the reference's ``jax.tree.map(jnp.where)``)."""
    return dataclasses.replace(new, **{
        f: torch.where(ok, getattr(new, f), getattr(old, f))
        for f in FIELDS})


# ---------------------------------------------------------------------------
# construction (paper Alg. 1)
# ---------------------------------------------------------------------------

def _empty_arrays(R: int, C: int, dim: int, dtype, device) -> dict:
    big = _big_for(dtype)
    kw = dict(device=device)
    return dict(
        pts=torch.zeros((R, C, dim), dtype=dtype, **kw),
        valid=torch.zeros((R, C), dtype=torch.bool, **kw),
        count=torch.zeros(R, dtype=torch.int32, **kw),
        active=torch.zeros(R, dtype=torch.bool, **kw),
        bbox_lo=torch.full((R, dim), big, dtype=dtype, **kw),
        bbox_hi=torch.full((R, dim), -big, dtype=dtype, **kw),
        cell_lo=torch.zeros((R, dim), dtype=dtype, **kw),
        cell_hi=torch.zeros((R, dim), dtype=dtype, **kw),
        cell_key=torch.full((R,), KEY_MAX, dtype=torch.int64, **kw),
        cell_depth=torch.zeros(R, dtype=torch.int32, **kw),
    )


def build(points, root_lo, root_hi, mask=None, *, phi: int = 32,
          lam: int = 3, rounds: int = 5,
          capacity_rows: int | None = None) -> POrthTree:
    """BuildPOrthTree via the segmented sieve."""
    n, dim = points.shape
    dev = points.device
    assert lam * rounds * dim <= 31, "key exceeds uint32"
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=dev)
    if capacity_rows is None:
        # orth cells may hold far fewer than phi points (4/8-ary splits
        # can overshoot), so rows scale with n, not n/phi
        capacity_rows = max(min(2 * n, 8 * ((n + phi - 1) // phi)), 16)
    R, C = capacity_rows, 2 * phi
    total_depth, key_bits = lam * rounds, lam * rounds * dim
    root_lo = torch.as_tensor(root_lo, device=dev).to(points.dtype)
    root_hi = torch.as_tensor(root_hi, device=dev).to(points.dtype)

    lo = root_lo.expand(n, dim)
    hi = root_hi.expand(n, dim)
    key = torch.zeros(n, dtype=torch.int64, device=dev)
    depth = torch.zeros(n, dtype=torch.int32, device=dev)
    s = _sieve_rounds(points, mask, lo, hi, key, depth, phi, lam, rounds,
                      total_depth, key_bits)
    arrays = _empty_arrays(R, C, dim, points.dtype, dev)
    freelist = torch.arange(R, dtype=torch.int32, device=dev)
    arrays, can_alloc = _finalize_rows(arrays, *s, phi, freelist)
    order, num_rows = _rebuild_order(arrays["active"], arrays["cell_key"])
    return POrthTree(**arrays, order=order, num_rows=num_rows,
                     overflowed=~can_alloc, root_lo=root_lo.clone(),
                     root_hi=root_hi.clone(), phi=phi, lam=lam,
                     rounds=rounds)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def point_keys(pts, root_lo, root_hi, *, lam: int, rounds: int):
    """Full-depth prefix key of each point via midpoint comparisons
    (Morton codes over the orth skeleton, for any coordinate dtype)."""
    n, dim = pts.shape
    lo = root_lo.to(pts.dtype).expand(n, dim)
    hi = root_hi.to(pts.dtype).expand(n, dim)
    key = torch.zeros(n, dtype=torch.int64, device=pts.device)
    for _ in range(rounds):
        bucket, lo, hi = _split_lambda_levels(pts, lo, hi, lam, dim)
        key = (key << (lam * dim)) | bucket
    return key


def _point_keys(tree: POrthTree, pts):
    return point_keys(pts, tree.root_lo, tree.root_hi, lam=tree.lam,
                      rounds=tree.rounds)


def _dir_keys(tree: POrthTree):
    return torch.where(tree.active, tree.cell_key,
                       KEY_MAX)[tree.order.long()]


def _route(tree: POrthTree, pkeys, ok):
    """Directory lookup + containment test: (row, contained), row id
    whose cell-key range the point key lands in; contained=False when
    that cell does not cover the point (an empty region)."""
    R = tree.capacity_rows
    j = (torch.searchsorted(_dir_keys(tree), pkeys, right=True) - 1
         ).clamp(0, R - 1)
    row = tree.order[j].long()
    rem = tree.key_bits - tree.cell_depth[row] * tree.dim
    contained = (((pkeys >> rem) == (tree.cell_key[row] >> rem))
                 & tree.active[row] & ok)
    return torch.where(ok, row, R), contained


def _empty_cell_seed(tree: POrthTree, pts, pkeys, missed):
    """For points in empty regions: the shallowest depth d* whose cell
    contains no existing row; returns (key, depth, lo, hi) of that cell
    per point."""
    n, dim = pts.shape
    dev = pts.device
    sorted_keys = _dir_keys(tree)
    num = tree.num_rows
    lo = tree.root_lo.to(pts.dtype).expand(n, dim)
    hi = tree.root_hi.to(pts.dtype).expand(n, dim)
    best_depth = torch.full((n,), tree.total_depth, dtype=torch.int32,
                            device=dev)
    best_key = pkeys
    best_lo, best_hi = lo, hi
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    cur_lo, cur_hi = lo, hi
    for d in range(tree.total_depth + 1):
        rem = tree.key_bits - d * dim
        if d > 0:
            prefix = (pkeys >> rem) << rem
            lo_i = torch.searchsorted(sorted_keys, prefix)
            # the reference's uint32 sum wraps past KEY_MAX
            hi_i = torch.searchsorted(sorted_keys,
                                      (prefix + (1 << rem)) & _U32)
            empty = (hi_i - lo_i) == 0
        else:
            prefix = torch.zeros_like(pkeys)
            empty = num == 0
        take = empty & ~found & missed
        best_depth = torch.where(take, d, best_depth)
        best_key = torch.where(take, prefix, best_key)
        best_lo = torch.where(take[:, None], cur_lo, best_lo)
        best_hi = torch.where(take[:, None], cur_hi, best_hi)
        found = found | take
        if d < tree.total_depth:
            # descend one level to track cell bounds
            mid = _midpoint(cur_lo, cur_hi)
            gt = pts >= mid
            cur_lo = torch.where(gt, mid, cur_lo)
            cur_hi = torch.where(gt, cur_hi, mid)
    return best_key, best_depth, best_lo, best_hi


# ---------------------------------------------------------------------------
# batch insertion (paper Alg. 2)
# ---------------------------------------------------------------------------

def _reset_rows(arrays: dict, mask) -> dict:
    a = dict(arrays)
    big = _big_for(a["pts"].dtype)
    a["valid"] = torch.where(mask[:, None], False, a["valid"])
    a["count"] = torch.where(mask, 0, a["count"])
    a["active"] = a["active"] & ~mask
    a["bbox_lo"] = torch.where(mask[:, None], big, a["bbox_lo"])
    a["bbox_hi"] = torch.where(mask[:, None], -big, a["bbox_hi"])
    a["cell_key"] = torch.where(mask, KEY_MAX, a["cell_key"])
    a["cell_depth"] = torch.where(mask, 0, a["cell_depth"])
    return a


def _rows_mask(row_ids, R: int):
    """(R,) bool: True at the non-negative entries of ``row_ids``."""
    m = torch.zeros(R + 1, dtype=torch.bool, device=row_ids.device)
    return m.index_fill_(0, torch.where(row_ids >= 0, row_ids, R).long(),
                         True)[:R]


def insert(tree: POrthTree, new_pts, new_mask=None, *,
           max_overflow_rows: int = 64) -> POrthTree:
    """Batch insertion: append into leaf cells, new leaves for empty
    regions, and a re-sieve of overflowing cells, all-or-nothing (on a
    capacity shortfall every field is the old tree's, with the sticky
    ``overflowed`` flag set)."""
    m, dim = new_pts.shape
    dev = new_pts.device
    new_pts = new_pts.to(tree.pts.dtype)
    if new_mask is None:
        new_mask = torch.ones(m, dtype=torch.bool, device=dev)
    R, C, phi = tree.capacity_rows, tree.row_capacity, tree.phi

    pkeys = _point_keys(tree, new_pts)
    skey = torch.where(new_mask, pkeys, KEY_MAX)
    perm = torch.argsort(skey, stable=True)
    s_keys, s_pts, s_ok = skey[perm], new_pts[perm], new_mask[perm]

    row_of, contained = _route(tree, s_keys, s_ok)
    missed = s_ok & ~contained
    row_app = torch.where(contained, row_of, R)
    adds = _add_drop(R, row_app, contained)
    over = tree.count + adds > C
    safe_app = row_app.clamp(0, R - 1)
    goes_over = over[safe_app] & contained
    fits = contained & ~goes_over

    # phase 1: append into leaf cells (orth leaves are naturally unsorted)
    pts_rows, valid_rows, count, _ = append_unsorted(
        tree.pts, tree.valid, tree.count, row_app, s_pts, fits)
    seg_lo, seg_hi = segment_bbox(s_pts, row_app, fits, R)
    bbox_lo = torch.minimum(tree.bbox_lo, seg_lo)
    bbox_hi = torch.maximum(tree.bbox_hi, seg_hi)

    # phase 2: rebuild buffer = overflowing cells' contents + their
    # incoming + points in empty regions, sieved from their seed cells
    MOR = max_overflow_rows
    orow_ids, n_over = take_k_where(over & tree.active, MOR)
    ovalid = orow_ids >= 0
    safe = orow_ids.clamp(min=0).long()
    old_pts = tree.pts[safe].reshape(MOR * C, dim)
    old_ok = (tree.valid[safe] & ovalid[:, None]).reshape(MOR * C)
    old_lo = tree.cell_lo[safe].repeat_interleave(C, dim=0)
    old_hi = tree.cell_hi[safe].repeat_interleave(C, dim=0)
    old_key = tree.cell_key[safe].repeat_interleave(C)
    old_depth = tree.cell_depth[safe].repeat_interleave(C)

    seed_key, seed_depth, seed_lo, seed_hi = _empty_cell_seed(
        tree, s_pts, s_keys, missed)
    # incoming points for overflowing rows seed at that row's cell
    inc_over = goes_over
    root_lo = tree.root_lo.to(s_pts.dtype).expand(m, dim)
    root_hi = tree.root_hi.to(s_pts.dtype).expand(m, dim)
    new_in = missed | goes_over
    b2_lo = torch.where(inc_over[:, None], tree.cell_lo[safe_app],
                        torch.where(missed[:, None], seed_lo, root_lo))
    b2_hi = torch.where(inc_over[:, None], tree.cell_hi[safe_app],
                        torch.where(missed[:, None], seed_hi, root_hi))
    b2_key = torch.where(inc_over, tree.cell_key[safe_app],
                         torch.where(missed, seed_key, 0))
    b2_depth = torch.where(inc_over, tree.cell_depth[safe_app],
                           torch.where(missed, seed_depth, 0))

    s = _sieve_rounds(torch.cat([old_pts, s_pts]),
                      torch.cat([old_ok, new_in]),
                      torch.cat([old_lo, b2_lo]), torch.cat([old_hi, b2_hi]),
                      torch.cat([old_key, b2_key]),
                      torch.cat([old_depth, b2_depth]),
                      phi, tree.lam, tree.rounds, tree.total_depth,
                      tree.key_bits)

    dropped = over & tree.active & _rows_mask(orow_ids, R)
    arrays = dict(pts=pts_rows, valid=valid_rows, count=count,
                  active=tree.active | (adds > 0),
                  bbox_lo=bbox_lo, bbox_hi=bbox_hi,
                  cell_lo=tree.cell_lo, cell_hi=tree.cell_hi,
                  cell_key=tree.cell_key, cell_depth=tree.cell_depth)
    # reset rows being rebuilt before re-filling
    arrays = _reset_rows(arrays, dropped)
    NR = MOR * (C // phi) + m + 2
    freelist, _ = take_k_where(~arrays["active"], NR)
    arrays, can_alloc = _finalize_rows(arrays, *s, phi, freelist)
    order, num_rows = _rebuild_order(arrays["active"], arrays["cell_key"])
    ok_all = can_alloc & (n_over <= MOR)
    new_tree = dataclasses.replace(tree, **arrays, order=order,
                                   num_rows=num_rows)
    # all-or-nothing: on a capacity shortfall the old tree comes back
    # with the overflowed flag set (the caller grows and retries)
    failed = dataclasses.replace(
        tree, overflowed=torch.ones((), dtype=torch.bool, device=dev))
    return _select(ok_all, new_tree, failed)


# ---------------------------------------------------------------------------
# batch deletion
# ---------------------------------------------------------------------------

def delete(tree: POrthTree, del_pts, del_mask=None) -> POrthTree:
    """Batch deletion + one merge pass.

    Banded deletion: a cell saturated by more than C duplicates spans
    several rows with an identical cell_key (orth cells cannot split
    equal points), so each entry walks the rows of its target cell's
    directory band, one per round (usually 1). The reference loops while
    any unmatched entry has band left; the port reads the widest band
    once (its one host read) and runs that many rounds, each predicated
    on the reference's loop condition, so later rounds are no-ops."""
    m, dim = del_pts.shape
    dev = del_pts.device
    del_pts = del_pts.to(tree.pts.dtype)
    if del_mask is None:
        del_mask = torch.ones(m, dtype=torch.bool, device=dev)
    R, C = tree.capacity_rows, tree.row_capacity

    pkeys = _point_keys(tree, del_pts)
    skey = torch.where(del_mask, pkeys, KEY_MAX)
    perm = torch.argsort(skey, stable=True)
    s_keys, s_pts, s_ok = skey[perm], del_pts[perm], del_mask[perm]
    row_of, contained = _route(tree, s_keys, s_ok)

    ck_t = tree.cell_key[row_of.clamp(0, R - 1)]
    dmc = _dir_keys(tree)
    iL = torch.searchsorted(dmc, ck_t)
    iR = torch.searchsorted(dmc, ck_t, right=True)
    rounds = int(torch.where(contained, iR - iL, 0).max()) if m else 0

    valid_rows, count = tree.valid, tree.count
    remaining = contained
    touched = torch.zeros(R, dtype=torch.bool, device=dev)
    order = tree.order.long()
    for o in range(rounds):
        live = remaining & (remaining & (iL + o <= iR - 1)).any()
        pos = torch.minimum(iL + o, iR - 1).clamp(0, R - 1)
        rows = torch.where(live, order[pos], R - 1)
        valid_rows, count, matched = ranked_delete(
            tree.pts, valid_rows, count, rows, s_pts, live, window=C)
        touched = touched | (_add_drop(R, rows, matched) > 0)
        remaining = remaining & ~matched

    cvalid, cpts = compact_rows(valid_rows, tree.pts)
    valid_rows = torch.where(touched[:, None], cvalid, valid_rows)
    pts_rows = torch.where(touched[:, None, None], cpts, tree.pts)

    active = tree.active & (count > 0)
    lo, hi = row_bbox_from_slots(pts_rows, valid_rows & active[:, None])
    bbox_lo = torch.where(touched[:, None], lo, tree.bbox_lo)
    bbox_hi = torch.where(touched[:, None], hi, tree.bbox_hi)
    cell_key = torch.where(active, tree.cell_key, KEY_MAX)
    cell_depth = torch.where(active, tree.cell_depth, 0)
    order, num_rows = _rebuild_order(active, cell_key)
    out = dataclasses.replace(
        tree, pts=pts_rows, valid=valid_rows, count=count, active=active,
        bbox_lo=bbox_lo, bbox_hi=bbox_hi, cell_key=cell_key,
        cell_depth=cell_depth, order=order, num_rows=num_rows)
    return merge_pass(out)


def merge_pass(tree: POrthTree) -> POrthTree:
    """One level of the paper's post-deletion flattening: sibling groups
    that are all leaves and whose total fits a leaf merge into their
    parent cell."""
    R, C, dim = tree.pts.shape
    dev = tree.device
    rem = torch.clamp(tree.key_bits - (tree.cell_depth - 1) * dim, 0, 31)
    parent_key = torch.where(tree.cell_depth > 0,
                             (tree.cell_key >> rem) << rem, KEY_MAX)
    parent_key = torch.where(tree.active, parent_key, KEY_MAX)
    # group rows by (parent_key, depth) via sort
    order = torch.argsort(parent_key, stable=True)
    skey = parent_key[order]
    sdepth = tree.cell_depth[order]
    scount = torch.where(tree.active, tree.count, 0)[order]
    same = torch.ones(R, dtype=torch.bool, device=dev)
    same[1:] = (skey[1:] != skey[:-1]) | (sdepth[1:] != sdepth[:-1])
    gid = (torch.cumsum(same, 0, dtype=torch.int32) - 1).long()
    gcount = torch.zeros(R, dtype=torch.int32, device=dev).index_add_(
        0, gid, scount)
    gsize = torch.zeros(R, dtype=torch.int32, device=dev).index_add_(
        0, gid, tree.active[order].int())
    # rows inside the parent's key range (any depth) -- must equal the
    # group size
    sorted_keys = _dir_keys(tree)
    rem_s = torch.clamp(tree.key_bits - (sdepth - 1) * dim, 0, 31)
    nxt = (skey + (torch.ones_like(skey) << rem_s)) & _U32   # uint32 wrap
    lo_i = torch.searchsorted(sorted_keys, skey)
    hi_i = torch.searchsorted(sorted_keys, nxt)
    hi_i = torch.where(nxt < skey, tree.num_rows, hi_i)  # wrap => till end
    in_range = (hi_i - lo_i).int()
    mergeable = ((gcount[gid] <= tree.phi) & (gsize[gid] > 1)
                 & (in_range == gsize[gid]) & (skey != KEY_MAX)
                 & (sdepth > 0))
    merge_row = _rows_mask(torch.where(mergeable, order, -1), R)

    # buffer: all points of merging rows, seeded at their *parent* cell
    MOR = min(64, R)
    mrow_ids, n_m = take_k_where(merge_row, MOR)
    mvalid = mrow_ids >= 0
    safe = mrow_ids.clamp(min=0).long()
    b_pts = tree.pts[safe].reshape(MOR * C, dim)
    b_ok = (tree.valid[safe] & mvalid[:, None]).reshape(MOR * C)
    pk = parent_key[safe].repeat_interleave(C)
    pd = (tree.cell_depth[safe] - 1).repeat_interleave(C)
    p_lo, p_hi = _cell_bounds_at_depth(tree, b_pts, pd)
    proceed = (n_m <= MOR) & (n_m > 0)
    b_ok = b_ok & proceed

    arrays = _reset_rows(_arrays(tree), merge_row & proceed)
    freelist, _ = take_k_where(~arrays["active"], MOR)
    arrays, can_alloc = _finalize_rows(
        arrays, b_pts, b_ok, p_lo, p_hi, pk, pd, tree.phi, freelist)
    order2, num_rows = _rebuild_order(arrays["active"], arrays["cell_key"])
    new_tree = dataclasses.replace(tree, **arrays, order=order2,
                                   num_rows=num_rows)
    return _select(can_alloc | ~proceed, new_tree, tree)


def _cell_bounds_at_depth(tree: POrthTree, pts, target_depth):
    """Cell bounds containing each point at the given per-point depth."""
    n, dim = pts.shape
    lo = tree.root_lo.to(pts.dtype).expand(n, dim)
    hi = tree.root_hi.to(pts.dtype).expand(n, dim)
    out_lo, out_hi = lo, hi
    for d in range(tree.total_depth):
        take = (target_depth == d)[:, None]
        out_lo = torch.where(take, lo, out_lo)
        out_hi = torch.where(take, hi, out_hi)
        mid = _midpoint(lo, hi)
        gt = pts >= mid
        lo = torch.where(gt, mid, lo)
        hi = torch.where(gt, hi, mid)
    take = (target_depth >= tree.total_depth)[:, None]
    return torch.where(take, lo, out_lo), torch.where(take, hi, out_hi)


def grow(tree: POrthTree, capacity_rows: int) -> POrthTree:
    """Pad the row arrays to a larger capacity."""
    R = tree.capacity_rows
    if capacity_rows <= R:
        return tree
    extra = capacity_rows - R

    def pad(a, fill):
        return torch.cat([a, a.new_full((extra,) + a.shape[1:], fill)])

    big = _big_for(tree.pts.dtype)
    arrays = dict(
        pts=pad(tree.pts, 0), valid=pad(tree.valid, False),
        count=pad(tree.count, 0), active=pad(tree.active, False),
        bbox_lo=pad(tree.bbox_lo, big), bbox_hi=pad(tree.bbox_hi, -big),
        cell_lo=pad(tree.cell_lo, 0), cell_hi=pad(tree.cell_hi, 0),
        cell_key=pad(tree.cell_key, KEY_MAX),
        cell_depth=pad(tree.cell_depth, 0))
    order, num_rows = _rebuild_order(arrays["active"], arrays["cell_key"])
    return dataclasses.replace(tree, **arrays, order=order,
                               num_rows=num_rows)


def free_rows(tree: POrthTree) -> int:
    return int((~tree.active).sum())


def extract_points(tree: POrthTree):
    """All (point, validity) pairs, flattened -- for rebuilds."""
    R, C, dim = tree.pts.shape
    ok = (tree.valid & tree.active[:, None]).reshape(R * C)
    return tree.pts.reshape(R * C, dim), ok


def compact(tree: POrthTree, capacity_rows: int | None = None) -> POrthTree:
    """Full rebuild (bulk rebalance / grow)."""
    pts, ok = extract_points(tree)
    return build(pts, tree.root_lo, tree.root_hi, ok, phi=tree.phi,
                 lam=tree.lam, rounds=tree.rounds,
                 capacity_rows=capacity_rows or tree.capacity_rows)
