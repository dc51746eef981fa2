"""The sieve's CUDA kernels (``csrc/sieve.cu``) and their wrappers.

Counterpart of ``repro/kernels/sieve/kernel.py:sieve_histogram_pallas``
(and of the jnp rank and scatter of ``repro/kernels/sieve/ops.py``):

* :func:`sieve_histogram_chunks` -- the bucket histogram of every chunk;
* :func:`sieve_rank_chunks` -- every chunk point's stable counting-sort
  destination, given the per-(chunk, bucket) offsets, and its bucket's
  cell.

Each launches its kernel for CUDA tensors and takes its plain version
(``ref.py``) for CPU tensors; any other device raises. Every launch of
either kernel adds one to :func:`launch_count`.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from .ref import sieve_histogram_plain, sieve_rank_plain

MAX_LEVEL_BITS = 10   # lam * D: at most 1024 buckets (shared-memory counts)
MAX_BLOCK_N = 4096    # points per chunk (their buckets stay in smem)

_STATS = {"launches": 0}


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return _STATS["launches"]


def reset_launch_count() -> None:
    _STATS["launches"] = 0


def _hist_fn():
    fn = build.load("sieve").sieve_hist_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2
    return fn


def _rank_fn():
    fn = build.load("sieve").sieve_rank_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
    return fn


def _check(name, pts, cell_lo, cell_hi, chunk_start, chunk_len, lam):
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
    M = chunk_start.shape[0]
    for t_name, t in (("chunk_start", chunk_start),
                      ("chunk_len", chunk_len)):
        if t.shape != (M,) or t.dtype != torch.int32 or t.device != dev:
            raise ValueError(f"{name}: {t_name} must be ({M},) int32 on "
                             f"{dev}")
    return [t.contiguous() for t in (pts, cell_lo, cell_hi, chunk_start,
                                      chunk_len)]


def sieve_histogram_chunks(pts, cell_lo, cell_hi, chunk_start, chunk_len,
                           *, lam: int):
    """Bucket histogram of every chunk: ``(n_chunks, 2^(lam*D))`` int32
    (zeros for an empty chunk); same contract as
    :func:`ref.sieve_histogram_plain`."""
    if pts.device.type == "cpu":
        return sieve_histogram_plain(pts, cell_lo, cell_hi, chunk_start,
                                     chunk_len, lam=lam)
    p, lo, hi, cs, cl = _check("sieve_histogram_chunks", pts, cell_lo,
                               cell_hi, chunk_start, chunk_len, lam)
    D = pts.shape[1]
    M = cs.shape[0]
    hist = torch.empty((M, 1 << (lam * D)), dtype=torch.int32,
                       device=pts.device)
    stream = torch.cuda.current_stream(pts.device).cuda_stream
    err = _hist_fn()(p.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                     int(pts.dtype == torch.float32), D, lam, cs.data_ptr(),
                     cl.data_ptr(), M, hist.data_ptr(), stream)
    _STATS["launches"] += 1
    build.check(err, "sieve_histogram_chunks")
    return hist


def sieve_rank_chunks(pts, cell_lo, cell_hi, chunk_start, chunk_len, offset,
                      *, lam: int, block_n: int):
    """Stable counting-sort destination, bucket and the bucket's cell
    of every chunk point (``chunk_len <= block_n``); same contract as
    :func:`ref.sieve_rank_plain`."""
    if pts.device.type == "cpu":
        return sieve_rank_plain(pts, cell_lo, cell_hi, chunk_start,
                                chunk_len, offset, lam=lam)
    p, lo, hi, cs, cl = _check("sieve_rank_chunks", pts, cell_lo, cell_hi,
                               chunk_start, chunk_len, lam)
    n, D = pts.shape
    M = cs.shape[0]
    dev = pts.device
    if offset.shape != (M, 1 << (lam * D)) or \
            offset.dtype != torch.int32 or offset.device != dev:
        raise ValueError(f"sieve_rank_chunks: offset must be ({M}, "
                         f"{1 << (lam * D)}) int32 on {dev}")
    if not 1 <= block_n <= MAX_BLOCK_N:
        raise ValueError(f"sieve_rank_chunks: block_n={block_n} outside "
                         f"1..{MAX_BLOCK_N}")
    off = offset.contiguous()
    dest = torch.arange(n, dtype=torch.int32, device=dev)
    bucket = torch.zeros(n, dtype=torch.int32, device=dev)
    child_lo, child_hi = lo.clone(), hi.clone()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _rank_fn()(p.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                     int(pts.dtype == torch.float32), D, lam, cs.data_ptr(),
                     cl.data_ptr(), M, block_n, off.data_ptr(),
                     dest.data_ptr(), bucket.data_ptr(), child_lo.data_ptr(),
                     child_hi.data_ptr(), stream)
    _STATS["launches"] += 1
    build.check(err, "sieve_rank_chunks")
    return dest, bucket, child_lo, child_hi
