"""SPaC-tree: the paper's parallel R-tree family (Sec. 4).

Counterpart of ``repro/core/spac.py``, field for field:

  * points live in rows of ``(R, C=2*phi)`` arrays (blocked leaves),
  * a *directory* (rows sorted by ``min_code``) plays the role of the
    join-balanced search tree: routing a point is one ``searchsorted``,
  * per-row bounding boxes give exact query pruning (``queries.py``).

Batch inserts append *unsorted* into leaf slack (the partial-order
relaxation); a leaf is sorted only when it overflows and is split into
fresh rows of ``phi`` from a freelist (Expose). Inserts are
all-or-nothing: on a capacity shortfall every field is the old tree's,
with the sticky ``overflowed`` flag set.

SFC codes are carried in ``int64`` (``CODE_MAX = 0xFFFFFFFF`` keeps the
reference's ``uint32`` order); :meth:`SpacTree.from_numpy` and
:meth:`SpacTree.to_numpy` convert to and from the reference's fields.
Updates are functional (each returns new tensors) and fixed-shape;
insert never reads the device from the host. Delete reads one scalar
per call: the number of directory-band rounds its walk needs.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..kernels.morton import kernel as morton_kernel
from . import sfc
from .leafstore import (_add_drop, _reduce_drop, append_unsorted,
                        chunk_rows_from_sorted, compact_rows,
                        group_occurrence, ranked_delete,
                        row_bbox_from_slots, scatter_to_rows, segment_bbox,
                        take_k_where)
from .queries import LeafView

CODE_MAX = 0xFFFFFFFF
_I32_MAX = 2 ** 31 - 1

FIELDS = ("pts", "codes", "valid", "count", "active", "bbox_lo", "bbox_hi",
          "min_code", "unsorted", "order", "num_rows", "overflowed")
_CODE_FIELDS = ("codes", "min_code")


@dataclasses.dataclass(frozen=True)
class SpacTree:
    pts: Any         # (R, C, D) int32 coordinates
    codes: Any       # (R, C) int64 SFC codes (< 2^32)
    valid: Any       # (R, C) bool
    count: Any       # (R,) int32
    active: Any      # (R,) bool
    bbox_lo: Any     # (R, D) int32
    bbox_hi: Any     # (R, D) int32
    min_code: Any    # (R,) int64 (CODE_MAX when inactive)
    unsorted: Any    # (R,) bool -- the partial-order flag
    order: Any       # (R,) int32 row ids sorted by min_code (inactive last)
    num_rows: Any    # () int32
    overflowed: Any  # () bool -- capacity exhausted (grow + retry needed)
    phi: int = 32
    curve: str = "hilbert"
    bits: int = 16
    coord_bits: int = 30

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

    def view(self) -> LeafView:
        return LeafView(self.pts, self.valid, self.active, self.bbox_lo,
                        self.bbox_hi)

    @property
    def size(self):
        """Live points (0-d device tensor)."""
        return torch.where(self.active, self.count, 0).sum()

    @classmethod
    def from_numpy(cls, fields: dict, meta: dict, device) -> "SpacTree":
        """A tree from the reference's fields as numpy arrays (``uint32``
        codes become ``int64``) and its static ``meta`` (phi, curve,
        bits, coord_bits)."""
        arrays = {}
        for name in FIELDS:
            a = np.asarray(fields[name])
            if name in _CODE_FIELDS:
                a = a.astype(np.int64)
            arrays[name] = torch.tensor(a, device=device)   # a copy
        return cls(**arrays, **meta)

    def to_numpy(self) -> dict:
        """The tree's fields as numpy arrays in the reference's dtypes."""
        out = {name: getattr(self, name).cpu().numpy() for name in FIELDS}
        for name in _CODE_FIELDS:
            out[name] = out[name].astype(np.uint32)
        return out

    @property
    def meta(self) -> dict:
        return dict(phi=self.phi, curve=self.curve, bits=self.bits,
                    coord_bits=self.coord_bits)


def _encode(pts, curve: str, bits: int, coord_bits: int):
    """Quantize coordinates to ``bits``/dim and encode (quantization only
    affects clustering order, never correctness). The Morton curve goes
    through the Morton op: the kernel on the card, its plain version on
    the CPU."""
    if curve == "hilbert":
        q = sfc._as_code(pts) >> max(0, coord_bits - bits)
        return sfc.hilbert_encode(q, bits)
    if curve == "morton":
        return morton_kernel.morton_encode(pts, bits=bits,
                                           coord_bits=coord_bits)
    raise ValueError(f"unknown curve {curve!r}")


def _dir_mincodes(tree: SpacTree):
    mc = torch.where(tree.active, tree.min_code, CODE_MAX)
    return mc[tree.order.long()]


def _rebuild_order(active, min_code):
    key = torch.where(active, min_code, CODE_MAX)
    order = torch.argsort(key, stable=True).int()
    return order, active.sum(dtype=torch.int32)


def _route(tree: SpacTree, codes):
    """Directory lookup: row id owning each code."""
    j = torch.searchsorted(_dir_mincodes(tree), codes, right=True) - 1
    return tree.order[j.clamp(0, tree.capacity_rows - 1)]


# ---------------------------------------------------------------------------
# construction (paper Alg. 3)
# ---------------------------------------------------------------------------

def build(points, mask=None, *, phi: int = 32, curve: str = "hilbert",
          bits: int = 16, coord_bits: int = 30,
          capacity_rows: int | None = None) -> SpacTree:
    """BuildSPaCTree: encode + stable sort of (code, id) pairs, then
    chunk the sorted points into phi-filled rows."""
    n, dim = points.shape
    dev = points.device
    points = points.to(torch.int32)
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=dev)
    if capacity_rows is None:
        capacity_rows = max(2 * ((n + phi - 1) // phi), 8)
    R, C = capacity_rows, 2 * phi

    key = torch.where(mask, _encode(points, curve, bits, coord_bits),
                      CODE_MAX)
    perm = torch.argsort(key, stable=True)
    s_codes, s_pts, s_ok = key[perm], points[perm], mask[perm]

    row, slot = chunk_rows_from_sorted(n, phi, dev)
    pts_rows = scatter_to_rows(
        torch.zeros((R, C, dim), dtype=torch.int32, device=dev), row, slot,
        s_pts, s_ok)
    codes_rows = scatter_to_rows(
        torch.zeros((R, C), dtype=torch.int64, device=dev), row, slot,
        s_codes, s_ok)
    valid_rows = scatter_to_rows(
        torch.zeros((R, C), dtype=torch.bool, device=dev), row, slot,
        torch.ones(n, dtype=torch.bool, device=dev), s_ok)
    count = _add_drop(R, row, s_ok)
    active = count > 0
    bbox_lo, bbox_hi = segment_bbox(s_pts, row, s_ok, R)
    min_code = _reduce_drop(
        torch.full((R,), CODE_MAX, dtype=torch.int64, device=dev), row,
        s_codes, s_ok, "amin")
    order, num_rows = _rebuild_order(active, min_code)
    return SpacTree(pts=pts_rows, codes=codes_rows, valid=valid_rows,
                    count=count, active=active, bbox_lo=bbox_lo,
                    bbox_hi=bbox_hi, min_code=min_code,
                    unsorted=torch.zeros(R, dtype=torch.bool, device=dev),
                    order=order, num_rows=num_rows,
                    overflowed=torch.zeros((), dtype=torch.bool,
                                           device=dev),
                    phi=phi, curve=curve, bits=bits, coord_bits=coord_bits)


# ---------------------------------------------------------------------------
# batch insertion (paper Alg. 4)
# ---------------------------------------------------------------------------

def insert(tree: SpacTree, new_pts, new_mask=None, *,
           max_overflow_rows: int = 64, sort_rows: bool = False) -> SpacTree:
    """Batch insertion: relaxed append into leaf slack, then Expose and
    split of the rows it overflows, all-or-nothing. ``sort_rows=True``
    sorts every row afterwards (the CPAM-like total-order baseline)."""
    m, dim = new_pts.shape
    dev = new_pts.device
    new_pts = new_pts.to(torch.int32)
    if new_mask is None:
        new_mask = torch.ones(m, dtype=torch.bool, device=dev)
    R, C = tree.capacity_rows, tree.row_capacity
    phi = tree.phi
    MOR = max_overflow_rows

    # --- sort the batch by code (HybridSort on the batch) ---
    key = torch.where(new_mask, _encode(new_pts, tree.curve, tree.bits,
                                        tree.coord_bits), CODE_MAX)
    perm = torch.argsort(key, stable=True)
    s_codes, s_pts, s_ok = key[perm], new_pts[perm], new_mask[perm]

    # --- route to rows (sorted batch => equal rows contiguous) ---
    row_of = torch.where(s_ok, _route(tree, s_codes), R)   # R => dropped
    adds = _add_drop(R, row_of, s_ok)
    over = tree.count + adds > C
    goes_over = over[row_of.clamp(0, R - 1).long()] & s_ok
    fits = s_ok & ~goes_over

    # --- phase 1: relaxed append into slack slots (no sorting) ---
    pts_rows, valid_rows, count, (codes_rows,) = append_unsorted(
        tree.pts, tree.valid, tree.count, row_of, s_pts, fits,
        extras_rows=(tree.codes,), new_extras=(s_codes,))
    seg_lo, seg_hi = segment_bbox(s_pts, row_of, fits, R)
    bbox_lo = torch.minimum(tree.bbox_lo, seg_lo)
    bbox_hi = torch.maximum(tree.bbox_hi, seg_hi)
    min_code = _reduce_drop(tree.min_code, row_of, s_codes, fits, "amin")
    touched = adds > 0
    unsorted = tree.unsorted | (touched & ~over)

    # --- phase 2: Expose + split overflowing rows ---
    orow_ids, n_over = take_k_where(over, MOR)
    ovalid_rows = orow_ids >= 0
    safe_rows = orow_ids.clamp(min=0).long()
    old_pts = tree.pts[safe_rows].reshape(MOR * C, dim)
    old_codes = tree.codes[safe_rows].reshape(MOR * C)
    old_ok = (tree.valid[safe_rows] & ovalid_rows[:, None]
              & tree.active[safe_rows][:, None]).reshape(MOR * C)
    buf_pts = torch.cat([old_pts, s_pts])
    buf_codes = torch.cat([old_codes, s_codes])
    buf_ok = torch.cat([old_ok, goes_over])
    n_buf = buf_pts.shape[0]

    # band = which overflowing row owns each buffer point; re-chunking
    # stays within a band so a fresh row never spans two source rows'
    # key ranges (the directory interval invariant)
    inv_map = torch.full((R + 1,), MOR, dtype=torch.int32, device=dev)
    inv_map = _reduce_drop(inv_map, safe_rows,
                           torch.arange(MOR, dtype=torch.int32, device=dev),
                           ovalid_rows, "amin")
    old_band = torch.arange(MOR * C, dtype=torch.int32, device=dev) // C
    new_band = inv_map[row_of.clamp(0, R).long()]
    buf_band = torch.where(buf_ok, torch.cat([old_band, new_band]), MOR)

    # Expose: order is restored here, lazily -- a lexicographic
    # (band, code) sort via two stable argsorts
    bkey = torch.where(buf_ok, buf_codes, CODE_MAX)
    p1 = torch.argsort(bkey, stable=True)
    bperm = p1[torch.argsort(buf_band[p1], stable=True)]
    b_codes, b_pts = bkey[bperm], buf_pts[bperm]
    b_ok, b_band = buf_ok[bperm], buf_band[bperm]

    # band-local chunking into rows of phi
    occ = group_occurrence(b_band)
    local_chunk = occ // phi
    nslot = occ % phi
    # dense-rank the (band, chunk) keys -> freelist slots
    K = C // phi + (m + phi - 1) // phi + 1
    fk = b_band.long() * K + local_chunk
    chg = b_ok.clone()
    chg[1:] &= fk[1:] != fk[:-1]
    dense = torch.cumsum(chg, dim=0, dtype=torch.int32) - 1
    nrow_needed = chg.sum(dtype=torch.int32)

    NR = MOR * (C // phi) + (m + phi - 1) // phi + MOR
    free_ids, _ = take_k_where(~tree.active & (adds == 0), NR)
    in_new = b_ok & (dense < NR)
    dest_row = torch.where(
        in_new,
        free_ids.clamp(min=0)[dense.clamp(0, free_ids.shape[0] - 1).long()],
        R)
    can_alloc = ((nrow_needed <= (free_ids >= 0).sum(dtype=torch.int32))
                 & (n_over <= MOR))
    dest_row = torch.where(can_alloc, dest_row, R)

    pts_rows = scatter_to_rows(pts_rows, dest_row, nslot, b_pts, in_new)
    codes_rows = scatter_to_rows(codes_rows, dest_row, nslot, b_codes,
                                 in_new)
    valid_rows = scatter_to_rows(
        valid_rows, dest_row, nslot,
        torch.ones(n_buf, dtype=torch.bool, device=dev), in_new)
    ncount = _add_drop(R, dest_row, dest_row < R)
    nlo, nhi = segment_bbox(b_pts, dest_row, in_new, R)
    nmin = _reduce_drop(
        torch.full((R,), CODE_MAX, dtype=torch.int64, device=dev), dest_row,
        b_codes, dest_row < R, "amin")

    newly_active = ncount > 0
    count = torch.where(newly_active, ncount, count)
    bbox_lo = torch.where(newly_active[:, None], nlo, bbox_lo)
    bbox_hi = torch.where(newly_active[:, None], nhi, bbox_hi)
    min_code = torch.where(newly_active, nmin, min_code)
    unsorted = unsorted & ~newly_active

    # activate appended rows; deactivate + fully reset the split rows
    dropped = over & can_alloc
    active = ((tree.active | (adds > 0)) & ~dropped) | newly_active
    valid_rows = valid_rows & ~dropped[:, None]
    count = torch.where(dropped, 0, count)
    bbox_lo = torch.where(dropped[:, None], _I32_MAX, bbox_lo)
    bbox_hi = torch.where(dropped[:, None], -_I32_MAX, bbox_hi)
    min_code = torch.where(dropped, CODE_MAX, min_code)
    unsorted = unsorted & ~dropped

    if sort_rows:  # CPAM-like total-order baseline: sort every row
        order_c = torch.argsort(torch.where(valid_rows, codes_rows,
                                            CODE_MAX), dim=1, stable=True)
        codes_rows = codes_rows.gather(1, order_c)
        valid_rows = valid_rows.gather(1, order_c)
        pts_rows = pts_rows.gather(1, order_c[..., None].expand(-1, -1,
                                                                dim))
        unsorted = torch.zeros_like(unsorted)

    order, num_rows = _rebuild_order(active, min_code)
    new_tree = dataclasses.replace(
        tree, pts=pts_rows, codes=codes_rows, valid=valid_rows, count=count,
        active=active, bbox_lo=bbox_lo, bbox_hi=bbox_hi, min_code=min_code,
        unsorted=unsorted, order=order, num_rows=num_rows)
    # all-or-nothing: on a capacity shortfall every field keeps the old
    # tree's value and the sticky overflowed flag is set
    ok_all = can_alloc & (n_over <= MOR)
    failed = dataclasses.replace(
        tree, overflowed=torch.ones((), dtype=torch.bool, device=dev))
    return dataclasses.replace(tree, **{
        f: torch.where(ok_all, getattr(new_tree, f), getattr(failed, f))
        for f in FIELDS})


# ---------------------------------------------------------------------------
# batch deletion
# ---------------------------------------------------------------------------

def delete(tree: SpacTree, del_pts, del_mask=None) -> SpacTree:
    """Batch deletion: banded route, ranked multiset match, intra-row
    compaction, bbox/min_code refresh of touched rows, directory rebuild.

    A code equal to a row's min_code may have copies in *preceding* rows
    too, so each entry's candidate band is directory positions
    ``[searchsorted_left - 1, searchsorted_right - 1]`` and the walk
    takes one band row per round. The reference loops while any unmatched
    entry has band left; the port reads the widest band once (its one
    host read) and runs that many rounds, each predicated on the
    reference's loop condition, so later rounds are exact no-ops."""
    m, dim = del_pts.shape
    dev = del_pts.device
    del_pts = del_pts.to(torch.int32)
    if del_mask is None:
        del_mask = torch.ones(m, dtype=torch.bool, device=dev)
    R, C = tree.capacity_rows, tree.row_capacity

    key = torch.where(del_mask, _encode(del_pts, tree.curve, tree.bits,
                                        tree.coord_bits), CODE_MAX)
    perm = torch.argsort(key, stable=True)
    s_codes, s_pts, s_ok = key[perm], del_pts[perm], del_mask[perm]

    dm = _dir_mincodes(tree)
    iL = torch.searchsorted(dm, s_codes, right=False)
    iR = torch.searchsorted(dm, s_codes, right=True)
    rounds = int(torch.where(s_ok, iR - iL + 1, 0).max()) if m else 0

    valid_rows, count = tree.valid, tree.count
    remaining = s_ok
    touched = torch.zeros(R, dtype=torch.bool, device=dev)
    order = tree.order.long()
    for o in range(rounds):
        walking = remaining & (iL - 1 + o <= iR - 1)
        live = remaining & walking.any()
        pos = torch.minimum(iL - 1 + o, iR - 1).clamp(0, R - 1)
        row_of = torch.where(live, order[pos], R - 1)
        valid_rows, count, matched = ranked_delete(
            tree.pts, valid_rows, count, row_of, s_pts, live, window=C)
        touched = touched | (_add_drop(R, row_of, matched) > 0)
        remaining = remaining & ~matched

    # intra-row stable compaction keeps `count == leading valid slots`
    cvalid, cpts, ccodes = compact_rows(valid_rows, tree.pts, tree.codes)
    valid_rows = torch.where(touched[:, None], cvalid, valid_rows)
    pts_rows = torch.where(touched[:, None, None], cpts, tree.pts)
    codes_rows = torch.where(touched[:, None], ccodes, tree.codes)

    active = tree.active & (count > 0)
    live_slots = valid_rows & active[:, None]
    lo, hi = row_bbox_from_slots(pts_rows, live_slots)
    bbox_lo = torch.where(touched[:, None], lo, tree.bbox_lo)
    bbox_hi = torch.where(touched[:, None], hi, tree.bbox_hi)
    mc = torch.where(live_slots, codes_rows, CODE_MAX).amin(dim=1)
    min_code = torch.where(touched, mc, tree.min_code)
    order, num_rows = _rebuild_order(active, min_code)
    return dataclasses.replace(
        tree, pts=pts_rows, codes=codes_rows, valid=valid_rows, count=count,
        active=active, bbox_lo=bbox_lo, bbox_hi=bbox_hi, min_code=min_code,
        order=order, num_rows=num_rows)


def grow(tree: SpacTree, capacity_rows: int) -> SpacTree:
    """Pad the row arrays to a larger capacity."""
    R = tree.capacity_rows
    if capacity_rows <= R:
        return tree
    extra = capacity_rows - R

    def pad(a, fill):
        return torch.cat([a, a.new_full((extra,) + a.shape[1:], fill)])

    arrays = dict(
        pts=pad(tree.pts, 0), codes=pad(tree.codes, 0),
        valid=pad(tree.valid, False), count=pad(tree.count, 0),
        active=pad(tree.active, False), bbox_lo=pad(tree.bbox_lo, _I32_MAX),
        bbox_hi=pad(tree.bbox_hi, -_I32_MAX),
        min_code=pad(tree.min_code, CODE_MAX),
        unsorted=pad(tree.unsorted, False))
    order, num_rows = _rebuild_order(arrays["active"], arrays["min_code"])
    return dataclasses.replace(tree, **arrays, order=order,
                               num_rows=num_rows)


def extract_points(tree: SpacTree):
    """All (point, validity) pairs, flattened -- for rebuilds."""
    R, C, dim = tree.pts.shape
    ok = (tree.valid & tree.active[:, None]).reshape(R * C)
    return tree.pts.reshape(R * C, dim), ok


def compact(tree: SpacTree, capacity_rows: int | None = None) -> SpacTree:
    """Full rebuild (bulk rebalance / grow)."""
    pts, ok = extract_points(tree)
    return build(pts, ok, phi=tree.phi, curve=tree.curve, bits=tree.bits,
                 coord_bits=tree.coord_bits,
                 capacity_rows=capacity_rows or tree.capacity_rows)
