"""The sieve's CUDA kernels (``csrc/sieve.cu``) and their wrappers.

Counterpart of ``repro/kernels/sieve/kernel.py:sieve_histogram_pallas``
(and of the jnp rank and scatter of ``repro/kernels/sieve/ops.py``):

* :func:`sieve_round` -- one sieve round, a stable counting sort by
  bucket inside every segment of active points: five launches behind one
  C call (the chunk pass, the single segments, the multi chunks'
  histograms, their scan, their ranks), sized to the points or to the
  chunks in use, with no host read;
* :func:`sieve_histogram_chunks` -- the bucket histogram of every given
  chunk (the reference-shaped ``ops.sieve_histogram``).

Each launches its kernels for CUDA tensors and takes its plain version
(``ref.py``) for CPU tensors; any other device raises. Every kernel
launch adds one to :func:`launch_count` (a round is five).
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from .ref import SieveRound, sieve_histogram_plain, sieve_round_plain

MAX_LEVEL_BITS = 10   # lam * D: at most 1024 buckets (shared-memory counts)
MAX_BLOCK_N = 4096    # points per chunk (their buckets stay in smem)
TILE = 4096           # points a CTA of the chunk pass takes

_STATS = {"launches": 0}
_FNS: dict = {}   # (library, entry point) -> the ctypes function
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {   # entry point -> (argument types, kernel launches a call)
    "sieve_round_launch": ([_P] * 3 + [_I] * 4 + [_P] * 2 + [_I] +
                           [_P] * 5 + [_I, _P, _P], 5),
    "sieve_hist_launch": ([_P] * 3 + [_I] * 3 + [_P] * 4 + [_I, _P], 1),
}


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return _STATS["launches"]


def reset_launch_count() -> None:
    _STATS["launches"] = 0


def _launch(name: str, *args) -> None:
    lib = build.load("sieve")
    fn = _FNS.get((id(lib), name))
    if fn is None:
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = _SIGS[name][0]
        _FNS[(id(lib), name)] = fn
    err = fn(*args)
    _STATS["launches"] += _SIGS[name][1]
    build.check(err, name)


def _check_points(name, pts, cell_lo, cell_hi, lam):
    dev = pts.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if pts.dim() != 2 or not 1 <= pts.shape[1] <= 3:
        raise ValueError(f"{name}: pts must be (N, D) with D in 1..3, got "
                         f"{tuple(pts.shape)}")
    if not 1 <= lam * pts.shape[1] <= MAX_LEVEL_BITS:
        raise ValueError(f"{name}: lam * D = {lam * pts.shape[1]} outside "
                         f"1..{MAX_LEVEL_BITS}")
    if pts.dtype not in (torch.int32, torch.float32):
        raise TypeError(f"{name}: points must be int32 or float32, got "
                        f"{pts.dtype}")
    for t_name, t in (("cell_lo", cell_lo), ("cell_hi", cell_hi)):
        if t.shape != pts.shape or t.dtype != pts.dtype or t.device != dev:
            raise ValueError(f"{name}: {t_name} must match pts in shape, "
                             f"dtype and device")
    return [t.contiguous() for t in (pts, cell_lo, cell_hi)]


def _check_vectors(name, dev, n, **vectors):
    for t_name, (t, dtype) in vectors.items():
        if t.shape != (n,) or t.dtype != dtype or t.device != dev:
            raise ValueError(f"{name}: {t_name} must be ({n},) {dtype} on "
                             f"{dev}")


def sieve_round(pts, cell_lo, cell_hi, seg_start, act, *, lam: int,
                block_n: int) -> SieveRound:
    """One sieve round: a stable counting sort by bucket inside every
    segment of active points (``seg_start[i]``: the first index of point
    ``i``'s segment, segments contiguous; ``act`` constant on a segment),
    segments in order, inactive points in place. Returns a
    :class:`ref.SieveRound`; on the card its chunk lists and tables are
    sized by the most a round could need (``ref.in_use`` cuts them)."""
    if pts.device.type == "cpu":
        return sieve_round_plain(pts, cell_lo, cell_hi, seg_start, act,
                                 lam=lam, block_n=block_n)
    p, lo, hi = _check_points("sieve_round", pts, cell_lo, cell_hi, lam)
    n, D = pts.shape
    dev = pts.device
    _check_vectors("sieve_round", dev, n, seg_start=(seg_start, torch.int32),
                   act=(act, torch.bool))
    if not 1 <= block_n <= MAX_BLOCK_N:
        raise ValueError(f"sieve_round: block_n={block_n} outside "
                         f"1..{MAX_BLOCK_N}")
    K = 1 << (lam * D)
    seg = seg_start.contiguous()
    flags = act.contiguous().view(torch.uint8)
    dest = torch.empty(n, dtype=torch.int32, device=dev)
    bucket = torch.empty(n, dtype=torch.int32, device=dev)
    clo, chi = torch.empty_like(lo), torch.empty_like(hi)
    # a segment of L > block_n points has ceil(L / block_n) < 2 L / block_n
    # chunks, so no round has more multi chunks than mcap; one workspace
    # holds the segment lengths, both chunk lists and the multi tables
    mcap = 2 * (n // block_n) + 1
    work = torch.empty(2 * n + mcap * (2 * K + 1) + K, dtype=torch.int32,
                       device=dev)
    _, single, multi, hist, prefix = torch.split(
        work, [n, n, mcap, K * mcap, K * (mcap + 1)])
    hist, prefix = hist.view(K, mcap), prefix.view(K, mcap + 1)
    n_tiles = -(-n // TILE)
    # the tiles' look-back words, then a ticket and the two counts
    scratch = torch.zeros(n_tiles + 2, dtype=torch.int64, device=dev)
    ctl = scratch[n_tiles:].view(torch.int32)
    counts = ctl[1:3]
    out = SieveRound(dest, bucket, clo, chi, single, multi, counts, hist,
                     prefix)
    if n == 0:
        return out
    _launch("sieve_round_launch", p.data_ptr(), lo.data_ptr(),
            hi.data_ptr(), int(pts.dtype == torch.float32), D, lam, block_n,
            seg.data_ptr(), flags.data_ptr(), n, dest.data_ptr(),
            bucket.data_ptr(), clo.data_ptr(), chi.data_ptr(),
            work.data_ptr(), mcap, scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    return out


def sieve_histogram_chunks(pts, cell_lo, cell_hi, chunk_start, chunk_len,
                           *, lam: int):
    """Bucket histogram of every chunk: ``(n_chunks, 2^(lam*D))`` int32
    (zeros for an empty chunk); same contract as
    :func:`ref.sieve_histogram_plain`."""
    if pts.device.type == "cpu":
        return sieve_histogram_plain(pts, cell_lo, cell_hi, chunk_start,
                                     chunk_len, lam=lam)
    p, lo, hi = _check_points("sieve_histogram_chunks", pts, cell_lo,
                              cell_hi, lam)
    D = pts.shape[1]
    M = chunk_start.shape[0]
    _check_vectors("sieve_histogram_chunks", pts.device, M,
                   chunk_start=(chunk_start, torch.int32),
                   chunk_len=(chunk_len, torch.int32))
    cs, cl = chunk_start.contiguous(), chunk_len.contiguous()
    hist = torch.empty((1 << (lam * D), max(M, 1)), dtype=torch.int32,
                       device=pts.device)
    count = torch.full((1,), M, dtype=torch.int32, device=pts.device)
    _launch("sieve_hist_launch", p.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            int(pts.dtype == torch.float32), D, lam, cs.data_ptr(),
            cl.data_ptr(), count.data_ptr(), hist.data_ptr(), hist.shape[1],
            torch.cuda.current_stream(pts.device).cuda_stream)
    return hist[:, :M].t().contiguous()
