"""Baseline indexes the paper compares against (Sec. 5, Fig. 3).

Counterpart of ``repro/core/baselines.py``, field for field:

* ``kd`` -- a kd-tree with object-median splits, built level by level
  (two stable argsorts a level); a batch update is a full rebuild.
* ``zd`` -- a Zd-tree-like orth-tree built by materializing Morton codes
  (the Morton op: the CUDA kernel on the card) and sorting them up
  front, then revealing ``lam * D`` code bits a round. Its cost against
  :func:`repro_torch.core.porth.build` is the paper's claim that the
  sieve avoids the encode-and-sort passes.

Both expose the shared ``LeafView``, so the query engine runs on them
unchanged. Path keys are ``uint32`` in the reference; the port carries
them in ``int64`` masked to 32 bits after every shift (``KEY_MAX`` stays
the sentinel), and zd's Morton codes are the port's 32-bit codes: zd
refuses ``bits * D > 32`` (the reference's ``uint64`` case).

Updates rebuild from the live points. The reference rebuilds from every
slot of the ``(R, C)`` rows, invalid ones masked; a stable sort keeps
masked entries out of the order of the live ones, so rebuilding from
the live points alone (in slot order) gives the same tree, without
sorting ``R * C`` entries. Selecting them reads their count from the
device: kd and zd updates synchronise, as the facade's size check does.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..kernels.morton import kernel as morton_kernel
from . import sfc
from .leafstore import _add_drop, run_first, scatter_to_rows, segment_bbox
from .porth import _group_stats
from .queries import LeafView

KEY_MAX = 0xFFFFFFFF
_U32 = 0xFFFFFFFF

FIELDS = ("pts", "valid", "count", "active", "bbox_lo", "bbox_hi")


@dataclasses.dataclass(frozen=True)
class LeafIndex:
    """Minimal static leaf-directory index (kd / zd baselines)."""
    pts: Any         # (R, C, D) coordinates
    valid: Any       # (R, C) bool
    count: Any       # (R,) int32
    active: Any      # (R,) bool
    bbox_lo: Any     # (R, D)
    bbox_hi: Any     # (R, D)
    phi: int = 32

    def view(self) -> LeafView:
        return LeafView(self.pts, self.valid, self.active, self.bbox_lo,
                        self.bbox_hi)

    @property
    def size(self):
        """Live points (0-d device tensor)."""
        return torch.where(self.active, self.count, 0).sum()

    @classmethod
    def from_numpy(cls, fields: dict, meta: dict, device) -> "LeafIndex":
        """An index from the reference's fields as numpy arrays and its
        static ``meta`` (phi)."""
        return cls(**{f: torch.tensor(np.asarray(fields[f]), device=device)
                      for f in FIELDS}, **meta)

    def to_numpy(self) -> dict:
        """The index's fields as numpy arrays in the reference's dtypes."""
        return {f: getattr(self, f).cpu().numpy() for f in FIELDS}

    @property
    def meta(self) -> dict:
        return dict(phi=self.phi)


def _finalize_groups(points, ok, key, phi: int, R: int) -> LeafIndex:
    """Chunk sorted groups into rows of phi (same chunking as porth)."""
    n, dim = points.shape
    dev = points.device
    gid, cnt, pos = _group_stats(torch.where(ok, key, KEY_MAX), ok)
    rows_per = (cnt + phi - 1) // phi
    change = torch.ones(n, dtype=torch.bool, device=dev)
    change[1:] = gid[1:] != gid[:-1]
    per_group = torch.where(change, rows_per, 0)
    incl = torch.cumsum(per_group, 0, dtype=torch.int32)
    goff = (incl - per_group)[torch.searchsorted(gid, gid)]
    row = goff + pos // phi
    slot = pos % phi
    in_new = ok & (row < R)
    C = 2 * phi
    pts_rows = scatter_to_rows(
        torch.zeros((R, C, dim), dtype=points.dtype, device=dev), row, slot,
        points, in_new)
    valid_rows = scatter_to_rows(
        torch.zeros((R, C), dtype=torch.bool, device=dev), row, slot,
        torch.ones(n, dtype=torch.bool, device=dev), in_new)
    count = _add_drop(R, row, in_new)
    lo, hi = segment_bbox(points, torch.where(in_new, row, R), in_new, R)
    return LeafIndex(pts=pts_rows, valid=valid_rows, count=count,
                     active=count > 0, bbox_lo=lo, bbox_hi=hi, phi=phi)


def _live_points(index: LeafIndex):
    """The live points in slot order (one host read: their count)."""
    R, C, dim = index.pts.shape
    ok = (index.valid & index.active[:, None]).reshape(R * C)
    return index.pts.reshape(R * C, dim)[ok]


def _rebuild_input(index: LeafIndex, new_pts, new_mask):
    live = _live_points(index)
    if new_mask is None:
        new_mask = torch.ones(new_pts.shape[0], dtype=torch.bool,
                              device=live.device)
    pts = torch.cat([live, new_pts.to(live.dtype)])
    mask = torch.cat([torch.ones(live.shape[0], dtype=torch.bool,
                                 device=live.device), new_mask])
    return pts, mask


def _with_rows(index: LeafIndex, m: int, kw: dict, default_rows) -> dict:
    """``kw`` with the reference's default ``capacity_rows`` filled in:
    the reference rebuilds over every slot plus the batch, ``R * C + m``
    entries, and sizes rows from that count."""
    if kw.get("capacity_rows") is None:
        R, C, _ = index.pts.shape
        kw = dict(kw, capacity_rows=default_rows(R * C + m, index.phi))
    return kw


# ---------------------------------------------------------------------------
# kd-tree: object-median splits, level-synchronous construction
# ---------------------------------------------------------------------------

def _kd_rows(n: int, phi: int) -> int:
    return max(4 * ((n + phi - 1) // phi), 16)


def kd_build(points, mask=None, *, phi: int = 32, max_depth: int = 24,
             capacity_rows: int | None = None) -> LeafIndex:
    n, dim = points.shape
    dev = points.device
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=dev)
    R = _kd_rows(n, phi) if capacity_rows is None else capacity_rows

    key = torch.zeros(n, dtype=torch.int64, device=dev)  # 1 bit a level
    pts, ok = points, mask
    for d in range(max_depth):
        # two stable sorts, by coordinate then by segment key, compose
        # into one permutation: sorted by coordinate within each segment
        p1 = torch.argsort(pts[:, d % dim], stable=True)
        skey = torch.where(ok, key, KEY_MAX)[p1]
        perm = p1[torch.argsort(skey, stable=True)]
        pts, ok, key = pts[perm], ok[perm], key[perm]
        _, cnt, pos = _group_stats(torch.where(ok, key, KEY_MAX), ok)
        act = ok & (cnt > phi)
        bit = (pos >= (cnt + 1) // 2).long()       # median split
        key = (key << 1) & _U32
        key = torch.where(act, key | bit, key)
    skey = torch.where(ok, key, KEY_MAX)
    perm = torch.argsort(skey, stable=True)
    return _finalize_groups(pts[perm], ok[perm], skey[perm], phi, R)


def kd_insert(index: LeafIndex, new_pts, new_mask=None, **kw) -> LeafIndex:
    """BHL-tree semantics: batch update = full rebuild."""
    pts, mask = _rebuild_input(index, new_pts, new_mask)
    return kd_build(pts, mask, phi=index.phi,
                    **_with_rows(index, new_pts.shape[0], kw, _kd_rows))


def multiset_subtract_mask(live_pts, live_ok, del_pts, del_ok=None):
    """keep-mask over ``live_pts`` after removing the ``del_pts``
    multiset: sort live and deleted points together by coordinates (a
    stable lexsort), group equal coordinates, and drop as many live
    copies of each group, first ones first, as it has delete entries."""
    n, m = live_pts.shape[0], del_pts.shape[0]
    dim = live_pts.shape[1]
    dev = live_pts.device
    if del_ok is None:
        del_ok = torch.ones(m, dtype=torch.bool, device=dev)
    allp = torch.cat([live_pts, del_pts.to(live_pts.dtype)])
    is_live = torch.cat([torch.ones(n, dtype=torch.bool, device=dev),
                         torch.zeros(m, dtype=torch.bool, device=dev)])
    okv = torch.cat([live_ok, del_ok])
    # the reference's lexsort (coordinate 0 primary) as chained stable
    # sorts, from the last coordinate up to the primary one
    order = torch.arange(n + m, device=dev)
    for k in range(dim - 1, -1, -1):
        order = order[torch.argsort(allp[order, k], stable=True)]
    sp, sl, so = allp[order], is_live[order], okv[order]
    idx = torch.arange(n + m, dtype=torch.int32, device=dev)
    newrun = torch.ones(n + m, dtype=torch.bool, device=dev)
    newrun[1:] = (sp[1:] != sp[:-1]).any(dim=-1)
    runstart = run_first(newrun)
    prev = (runstart - 1).clamp(min=0).long()
    # deletes per run, broadcast to the run's members
    is_del = ~sl & so
    run_id = (torch.cumsum(newrun, 0, dtype=torch.int32) - 1).long()
    run_dels = torch.zeros(n + m, dtype=torch.int32, device=dev)
    run_dels.index_add_(0, run_id, is_del.int())
    run_dels = run_dels[run_id]
    # rank of each valid live entry among its run's valid live entries
    is_lv = sl & so
    clive = torch.cumsum(is_lv, 0, dtype=torch.int32)
    clive_start = torch.where(runstart > 0, clive[prev], 0)
    live_rank = clive - clive_start - 1
    keep_sorted = is_lv & (live_rank >= run_dels)
    keep = torch.zeros(n + m, dtype=torch.bool, device=dev)
    keep[order] = keep_sorted
    return keep[:n]


def kd_delete(index: LeafIndex, del_pts, del_mask=None, **kw) -> LeafIndex:
    """Full rebuild without the deleted multiset (rank-matched)."""
    live = _live_points(index)
    ok = torch.ones(live.shape[0], dtype=torch.bool, device=live.device)
    keep = multiset_subtract_mask(live, ok, del_pts, del_mask)
    return kd_build(live, keep, phi=index.phi,
                    **_with_rows(index, 0, kw, _kd_rows))


# ---------------------------------------------------------------------------
# Zd-tree-like: explicit Morton presort, then orth structure from codes
# ---------------------------------------------------------------------------

def _zd_rows(n: int, phi: int) -> int:
    return max(min(2 * n, 8 * ((n + phi - 1) // phi)), 16)


def zd_build(points, mask=None, *, phi: int = 32, bits: int = 15,
             coord_bits: int = 20, lam: int = 3,
             capacity_rows: int | None = None) -> LeafIndex:
    """Materialize Morton codes, sort them, then reveal ``lam * D`` bits
    a round to derive the orth leaf cells -- the extra encode pass and
    full-precision sort that the P-Orth tree avoids (paper Sec. 3)."""
    n, dim = points.shape
    dev = points.device
    sfc._check_width(dim, bits)
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=dev)
    R = _zd_rows(n, phi) if capacity_rows is None else capacity_rows
    codes = morton_kernel.morton_encode(points, bits=bits,
                                        coord_bits=coord_bits)
    skey = torch.where(mask, codes, KEY_MAX)
    perm = torch.argsort(skey, stable=True)
    pts, ok, codes = points[perm], mask[perm], skey[perm]

    total_bits = bits * dim
    key = torch.zeros(n, dtype=torch.int64, device=dev)   # revealed prefix
    depth_bits = torch.zeros(n, dtype=torch.int64, device=dev)
    rounds = (total_bits + lam * dim - 1) // (lam * dim)
    for _ in range(rounds):
        _, cnt, _ = _group_stats(torch.where(ok, key, KEY_MAX), ok)
        act = ok & (cnt > phi) & (depth_bits < total_bits)
        nb = (total_bits - depth_bits).clamp(max=lam * dim)
        newly = codes >> (total_bits - depth_bits - nb).clamp(min=0)
        mask_keep = (1 << nb) - 1
        key = torch.where(act, ((key << nb) & _U32) | (newly & mask_keep),
                          key)
        depth_bits = torch.where(act, depth_bits + nb, depth_bits)
        # sorted by the full code, so groups stay contiguous: no re-sort
    # keys to a common shift: groups share a prefix but may differ in
    # depth -- disjoint cells in code order, so still contiguous
    fkey = torch.where(ok, (key << (total_bits - depth_bits)) & _U32,
                       KEY_MAX)
    return _finalize_groups(pts, ok, fkey, phi, R)


def zd_insert(index: LeafIndex, new_pts, new_mask=None, **kw) -> LeafIndex:
    """Merge-rebuild update (the original Zd update algorithm is not
    reproduced; this baseline isolates the construction-cost claim)."""
    pts, mask = _rebuild_input(index, new_pts, new_mask)
    return zd_build(pts, mask, phi=index.phi,
                    **_with_rows(index, new_pts.shape[0], kw, _zd_rows))


def zd_delete(index: LeafIndex, del_pts, del_mask=None, **kw) -> LeafIndex:
    """Merge-rebuild without the deleted multiset (rank-matched)."""
    live = _live_points(index)
    ok = torch.ones(live.shape[0], dtype=torch.bool, device=live.device)
    keep = multiset_subtract_mask(live, ok, del_pts, del_mask)
    return zd_build(live, keep, phi=index.phi,
                    **_with_rows(index, 0, kw, _zd_rows))
