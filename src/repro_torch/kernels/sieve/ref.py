"""Plain PyTorch versions of the sieve kernels.

Counterpart of ``repro/kernels/sieve/ref.py``. A *chunk* is a run of
consecutive points ``[chunk_start[c], chunk_start[c] + chunk_len[c])``;
chunks are ordered by start and disjoint, and an unused chunk has length
0 and start ``N`` (see ``ops.py``). The histogram and the rank are taken
per chunk, exactly as the CUDA kernels take them.
"""

from __future__ import annotations

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
