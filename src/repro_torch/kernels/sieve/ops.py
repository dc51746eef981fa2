"""The sieve as a counting sort: chunking, offsets and routing.

Counterpart of ``repro/kernels/sieve/ops.py``. :func:`sieve_histogram`
and :func:`sieve_partition` keep the reference's names and results (one
segment, fixed blocks of ``block_n`` points). :func:`segmented_partition`
is the form the P-Orth build runs once per sieve round: a stable
counting sort by bucket inside every segment of active points, with the
segment order kept and every other point left in place, that also gives
each active point its bucket's cell.

On the card a round is :func:`kernel.sieve_round`: kernels sized to the
chunks in use, which stay in device memory, so a round enqueues its work
without a sync. On the CPU it is the plain route below: fixed-shape
chunk tables (:func:`segment_chunks`), the chunk histograms, and the
reference's "matrix-transpose redistribution" (:func:`chunk_offsets`:
an exclusive scan of the histograms in (segment, bucket, chunk) order)
before the rank.
"""

from __future__ import annotations

import torch

from .kernel import sieve_histogram_chunks, sieve_round
from .ref import sieve_histogram_plain, sieve_rank_plain

BLOCK_N = 1024


def max_chunks(n: int, phi: int, block_n: int = BLOCK_N) -> int:
    """Chunks :func:`segment_chunks` can need when every segment of
    active points holds more than ``phi`` points: ``ceil(L / block_n)``
    per segment of length ``L`` sums to at most ``n / block_n`` plus the
    number of segments. Sizes the CPU route's tables; the card's round
    sizes its own by ``n``."""
    return n // block_n + n // (phi + 1) + 1


def segment_chunks(seg_start, act, *, block_n: int, n_chunks: int):
    """Chunks of at most ``block_n`` consecutive active points, each
    inside one segment (``seg_start[i]``: the first index of point
    ``i``'s segment; ``act`` is constant on a segment). Returns
    ``(chunk_start, chunk_len)``, ``(n_chunks,)`` int32 each; unused
    chunks have start ``N`` and length 0."""
    n = seg_start.shape[0]
    dev = seg_start.device
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    flag = act & ((idx - seg_start) % block_n == 0)
    cid = torch.cumsum(flag, 0, dtype=torch.int32) - 1
    start = torch.full((n_chunks + 1,), n, dtype=torch.int32, device=dev)
    start[torch.where(flag & (cid < n_chunks), cid, n_chunks).long()] = idx
    length = torch.zeros(n_chunks + 1, dtype=torch.int32, device=dev)
    length.index_add_(0, torch.where(act & (cid >= 0) & (cid < n_chunks),
                                     cid, n_chunks).long(),
                      torch.ones(n, dtype=torch.int32, device=dev))
    return start[:n_chunks], length[:n_chunks]


def chunk_offsets(hist, chunk_start, chunk_len, chunk_seg):
    """Destination of the first point of each (chunk, bucket): the
    chunk's segment start, plus the segment's points of lower buckets,
    plus the same bucket's points in the segment's earlier chunks.
    ``chunk_seg``: each chunk's segment start. (n_chunks, K) int32.

    A segment's chunks are consecutive, so its totals are the inclusive
    scan at its last chunk minus the exclusive scan at its first: two
    gathers, no scatter into a few hot rows. The scan over chunks runs
    along the contiguous axis of the transposed histograms (a scan over
    dim 0 of an (M, K) tensor gives each of the K columns one thread)."""
    M = hist.shape[0]
    idx = torch.arange(M, device=hist.device)
    first = (chunk_len > 0) & (chunk_start == chunk_seg)
    last = torch.ones_like(first)
    last[:-1] = first[1:] | (chunk_len[1:] == 0)
    fc = torch.cummax(torch.where(first, idx, 0), dim=0).values
    lc = torch.cummin(torch.where(last, idx, M - 1).flip(0),
                      dim=0).values.flip(0)
    incl = torch.cumsum(hist.t().contiguous(), 1, dtype=torch.int32).t()
    base = (incl - hist)[fc]
    total = incl[lc] - base
    below = torch.cumsum(total, 1, dtype=torch.int32) - total
    return chunk_seg[:, None] + below + (incl - hist) - base


def segmented_partition(pts, cell_lo, cell_hi, seg_start, act, *, lam: int,
                        n_chunks: int, block_n: int = BLOCK_N):
    """Stable counting sort by bucket inside every segment of active
    points (``act`` constant on a segment), segments in order, inactive
    points in place. Returns ``(dest, bucket, lo, hi)``: ``dest[i]`` is
    point ``i``'s new position, ``bucket`` (0 off ``act``) its bucket,
    and ``lo``/``hi`` its bucket's cell (its own cell off ``act``).
    CUDA tensors take :func:`kernel.sieve_round`; CPU tensors the plain
    route, whose tables ``n_chunks`` must bound (see
    :func:`max_chunks`)."""
    if pts.device.type != "cpu":
        r = sieve_round(pts, cell_lo, cell_hi, seg_start, act, lam=lam,
                        block_n=block_n)
        return r.dest, r.bucket, r.lo, r.hi
    n = pts.shape[0]
    cs, cl = segment_chunks(seg_start, act, block_n=block_n,
                            n_chunks=n_chunks)
    hist = sieve_histogram_plain(pts, cell_lo, cell_hi, cs, cl, lam=lam)
    seg = seg_start[cs.clamp(max=max(n - 1, 0)).long()] if n else cs
    offset = chunk_offsets(hist, cs, cl, seg)
    return sieve_rank_plain(pts, cell_lo, cell_hi, cs, cl, offset, lam=lam)


def _one_segment(pts, block_n):
    n = pts.shape[0]
    zeros = torch.zeros(n, dtype=torch.int32, device=pts.device)
    ones = torch.ones(n, dtype=torch.bool, device=pts.device)
    return zeros, ones, -(-n // block_n)


def sieve_histogram(pts, cell_lo, cell_hi, *, lam: int,
                    block_n: int = BLOCK_N):
    """Per-block bucket histograms, ``(ceil(N / block_n), 2^(lam*D))``
    int32: the reference's ``sieve_histogram`` (and so its TPU
    kernel's output)."""
    seg, act, nb = _one_segment(pts, block_n)
    cs, cl = segment_chunks(seg, act, block_n=block_n, n_chunks=nb)
    return sieve_histogram_chunks(pts, cell_lo, cell_hi, cs, cl, lam=lam)


def sieve_partition(pts, cell_lo, cell_hi, *, lam: int,
                    block_n: int = BLOCK_N):
    """Stable counting sort of all points by bucket: the reference's
    ``(dest, bucket, offsets)``, ``offsets[b]`` the start of bucket
    ``b``."""
    seg, act, nb = _one_segment(pts, block_n)
    dest, bucket, _, _ = segmented_partition(pts, cell_lo, cell_hi, seg,
                                             act, lam=lam, n_chunks=nb,
                                             block_n=block_n)
    counts = torch.zeros(1 << (lam * pts.shape[1]), dtype=torch.int32,
                         device=pts.device)
    counts.index_add_(0, bucket.long(), torch.ones_like(bucket))
    return dest, bucket, torch.cumsum(counts, 0, dtype=torch.int32) - counts
