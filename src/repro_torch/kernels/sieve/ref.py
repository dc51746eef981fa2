"""Plain PyTorch versions of the sieve kernels.

Counterpart of ``repro/kernels/sieve/ref.py``. A *chunk* is a run of
consecutive points ``[chunk_start[c], chunk_start[c] + chunk_len[c])``;
chunks are ordered by start and disjoint, and an unused chunk has length
0 and start ``N`` (see ``ops.py``). :func:`sieve_histogram_plain` and
:func:`sieve_rank_plain` take the histogram and the rank per chunk, the
CPU route of ``ops.segmented_partition`` (with ``ops.chunk_offsets``).

:func:`sieve_round_plain` spells the CUDA round's decomposition
(``csrc/sieve.cu``): segments of at most ``block_n`` active points
sorted in one pass, longer ones cut into chunks whose bucket counts are
scanned over the chunks in use. It returns the kernels' intermediates
too (:class:`SieveRound`), so the CPU tests can show the decomposition
changes no bit and the card can hold each kernel against it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def midpoint(lo, hi):
    """The reference's cell midpoint: ``lo + (hi - lo) * 0.5`` for
    floats, ``lo + floor((hi - lo) / 2)`` for integers."""
    if lo.dtype.is_floating_point:
        return lo + (hi - lo) * 0.5
    return lo + torch.div(hi - lo, 2, rounding_mode="floor")


def split_levels(pts, cell_lo, cell_hi, *, lam: int):
    """The lambda-level bucket of each point inside its cell -- lam
    rounds of D midpoint compares, dimension 0 in the high bit -- and the
    bucket's cell. Returns (bucket (N,) int32, lo', hi')."""
    lo, hi = cell_lo, cell_hi
    dim = pts.shape[1]
    bucket = torch.zeros(pts.shape[0], dtype=torch.int32, device=pts.device)
    for _ in range(lam):
        mid = midpoint(lo, hi)
        gt = pts >= mid
        for d in range(dim):
            bucket = (bucket << 1) | gt[:, d].int()
        lo = torch.where(gt, mid, lo)
        hi = torch.where(gt, hi, mid)
    return bucket, lo, hi


def point_chunk(n: int, chunk_start, chunk_len, device):
    """The chunk of each of ``n`` points, and whether it lies in one."""
    idx = torch.arange(n, dtype=torch.int32, device=device)
    if chunk_start.numel() == 0:
        return idx.long() * 0, torch.zeros(n, dtype=torch.bool,
                                           device=device)
    c = torch.searchsorted(chunk_start, idx, right=True).long() - 1
    cc = c.clamp(min=0)
    inside = (c >= 0) & (idx < chunk_start[cc] + chunk_len[cc])
    return cc, inside


def sieve_histogram_plain(pts, cell_lo, cell_hi, chunk_start, chunk_len, *,
                          lam: int):
    """Bucket histogram of every chunk: (n_chunks, 2^(lam*D)) int32."""
    n, dim = pts.shape
    K = 1 << (lam * dim)
    M = chunk_start.shape[0]
    c, inside = point_chunk(n, chunk_start, chunk_len, pts.device)
    b = split_levels(pts, cell_lo, cell_hi, lam=lam)[0].long()
    flat = torch.where(inside, c * K + b, M * K)
    hist = torch.zeros(M * K + 1, dtype=torch.int32, device=pts.device)
    hist.index_add_(0, flat, torch.ones(n, dtype=torch.int32,
                                        device=pts.device))
    return hist[: M * K].reshape(M, K)


def sieve_rank_plain(pts, cell_lo, cell_hi, chunk_start, chunk_len, offset,
                     *, lam: int):
    """Stable counting-sort destination of every point in a chunk:
    ``offset[c, b]`` plus the point's rank among the earlier points of
    its chunk with the same bucket. Returns ``(dest, bucket, lo, hi)``:
    ``dest`` and ``bucket`` (N,) int32, and each point's cell bounds,
    its bucket's cell for a point in a chunk. A point outside every
    chunk keeps ``dest = i``, ``bucket = 0`` and its bounds."""
    n, dim = pts.shape
    K = 1 << (lam * dim)
    dev = pts.device
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    c, inside = point_chunk(n, chunk_start, chunk_len, dev)
    b, lo, hi = split_levels(pts, cell_lo, cell_hi, lam=lam)
    key = torch.where(inside, c * K + b.long(), chunk_start.shape[0] * K)
    perm = torch.argsort(key, stable=True)
    skey = key[perm]
    change = torch.ones(n, dtype=torch.bool, device=dev)
    change[1:] = skey[1:] != skey[:-1]
    first = torch.cummax(torch.where(change, idx, 0), dim=0).values
    rank = torch.empty_like(idx)
    rank[perm] = idx - first
    if offset.numel():
        at = offset[c, b.long()]
    else:
        at = torch.zeros_like(idx)
    dest = torch.where(inside, at + rank, idx)
    return (dest, torch.where(inside, b, 0),
            torch.where(inside[:, None], lo, cell_lo),
            torch.where(inside[:, None], hi, cell_hi))


class SieveRound(NamedTuple):
    """One sieve round's outputs and intermediates.

    ``dest``, ``bucket``, ``lo``, ``hi``: the round's result (see
    ``ops.segmented_partition``). ``single``: the starts of the segments
    of at most ``block_n`` active points; ``multi``: the starts of the
    chunks of the longer ones, both in point order; ``counts``: ``(2,)``
    int32, how many of each are in use. ``hist``: ``(K, ld)``, column
    ``m`` the bucket counts of multi chunk ``m``; ``prefix``: ``(K, ld +
    1)``, ``prefix[b, m]`` the sum of ``hist[b, :m]``. The kernels size
    these by the most a round could need and leave the counts on the
    card; :func:`in_use` cuts them to the entries in use."""
    dest: torch.Tensor
    bucket: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    single: torch.Tensor
    multi: torch.Tensor
    counts: torch.Tensor
    hist: torch.Tensor
    prefix: torch.Tensor


def in_use(r: SieveRound) -> SieveRound:
    """``r`` with its chunk lists and tables cut to the entries in use
    (reads the counts back to the host)."""
    ns, nm = (int(c) for c in r.counts.tolist())
    return r._replace(single=r.single[:ns], multi=r.multi[:nm],
                      hist=r.hist[:, :nm], prefix=r.prefix[:, :nm + 1])


def _rank_in_runs(key):
    """Each entry's rank among the earlier entries with its key."""
    n = key.shape[0]
    perm = torch.argsort(key, stable=True)
    skey = key[perm]
    pos = torch.arange(n, device=key.device)
    change = torch.ones(n, dtype=torch.bool, device=key.device)
    change[1:] = skey[1:] != skey[:-1]
    first = torch.cummax(torch.where(change, pos, 0), dim=0).values
    rank = torch.empty_like(pos)
    rank[perm] = pos - first
    return rank


def sieve_round_plain(pts, cell_lo, cell_hi, seg_start, act, *, lam: int,
                      block_n: int) -> SieveRound:
    """The CUDA round's decomposition in plain PyTorch (data-dependent
    shapes; reads back to the host). Same contract as
    ``ops.segmented_partition``; the intermediates are those the kernels
    keep, cut to the entries in use."""
    n, dim = pts.shape
    K = 1 << (lam * dim)
    dev = pts.device
    i64 = torch.arange(n, device=dev)
    seg = seg_start.long()
    off = i64 - seg
    # the chunk pass: chunk starts, single or multi, and segment lengths
    head = act & (off % block_n == 0)
    ahead = seg[(i64 + block_n).clamp(max=max(n - 1, 0))]
    long_seg = (off >= block_n) | ((i64 + block_n < n) & (ahead == seg))
    single = i64[head & ~long_seg]
    multi = i64[head & long_seg]
    nxt = torch.cat([seg[1:], seg.new_full((min(n, 1),), -1)])
    last = act & (nxt != seg)
    seglen = torch.zeros(n, dtype=torch.long, device=dev)
    seglen[seg[last]] = off[last] + 1
    L = seglen[seg]
    b, lo, hi = split_levels(pts, cell_lo, cell_hi, lam=lam)
    b = b.long()
    in_s = act & (L <= block_n)
    in_m = act & (L > block_n)
    ns, nm = single.shape[0], multi.shape[0]
    # multi chunks: bucket counts, their scan over the chunks in use, and
    # each chunk's first destination per bucket
    chunk = (torch.searchsorted(multi, i64, right=True) - 1).clamp(min=0)
    hist = torch.zeros(K * nm + 1, dtype=torch.int32, device=dev)
    hist.index_add_(0, torch.where(in_m, b * nm + chunk, K * nm),
                    torch.ones(n, dtype=torch.int32, device=dev))
    hist = hist[:K * nm].reshape(K, nm)
    prefix = torch.cat([torch.zeros((K, 1), dtype=torch.int32, device=dev),
                        torch.cumsum(hist, 1, dtype=torch.int32)], 1)
    cseg = seg[multi]
    m = torch.arange(nm, device=dev)
    m0 = m - (multi - cseg) // block_n
    m1 = m0 + (seglen[cseg] + block_n - 1) // block_n
    total = prefix[:, m1] - prefix[:, m0]                   # (K, nm)
    below = torch.cumsum(total, 0, dtype=torch.int32) - total
    first_m = cseg[None, :] + below + prefix[:, m] - prefix[:, m0]
    # single segments: bucket counts, their exclusive scan, from the start
    sid = (torch.searchsorted(single, i64, right=True) - 1).clamp(min=0)
    scount = torch.zeros(K * ns + 1, dtype=torch.int32, device=dev)
    scount.index_add_(0, torch.where(in_s, sid * K + b, K * ns),
                      torch.ones(n, dtype=torch.int32, device=dev))
    scount = scount[:K * ns].reshape(ns, K)
    first_s = single[:, None] + torch.cumsum(scount, 1) - scount  # (ns, K)
    # the stable rank inside each chunk (single segment), by bucket
    group = torch.where(in_m, chunk, nm + sid)
    rank = _rank_in_runs(torch.where(act, group * K + b, (nm + ns) * K))
    at = torch.where(in_m, first_m[b, chunk] if nm else rank,
                     first_s[sid, b] if ns else rank)
    dest = torch.where(act, at + rank, i64).int()
    return SieveRound(
        dest, torch.where(act, b, 0).int(),
        torch.where(act[:, None], lo, cell_lo),
        torch.where(act[:, None], hi, cell_hi), single.int(), multi.int(),
        torch.tensor([ns, nm], dtype=torch.int32, device=dev), hist,
        prefix)
