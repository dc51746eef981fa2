"""Flat (brute-force) exact kNN: the CUDA kernel ``csrc/knn_flat.cu``
and its plain PyTorch version.

Counterpart of ``repro/kernels/knn/kernel.py:knn_pallas``. The TPU
kernel's uncentered MXU identity is not carried over: the kernel
computes the direct ``sum_d (q_d - p_d)^2`` (see ``ref.py``) and so
matches ``repro/kernels/knn/ref.py:knn_ref`` rather than the TPU
kernel's rounding.

:func:`knn_flat` launches the kernel for CUDA tensors and takes the
plain version for CPU tensors; any other device raises. Each call that
launches adds one to :func:`launch_count` (the kernel is two launches:
the split scan and the merge). :func:`split_plan` sizes the grid;
``ref.knn_flat_split_plain`` spells the split and merge.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from .ref import BIG, direct_d2, split_size

MAX_K = 128   # the largest k (above REG_K a top-k lives in shared memory)
REG_K = 16    # up to here a thread's top-k sits in registers
CTAS_PER_SM = 4   # the grid the split plan aims for
MAX_SPLITS = 32   # the merge takes one split's list a lane of a warp

_STATS = {"launches": 0}
_SMS: dict = {}   # device index -> multiprocessors
_FNS: dict = {}   # library -> its ctypes launch function


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return _STATS["launches"]


def reset_launch_count() -> None:
    _STATS["launches"] = 0


def knn_flat_plain(queries, points, ok, *, k: int):
    """Plain version: direct-form f32 distances, invalid slots at BIG,
    then a stable sort (ties by point index, like ``lax.top_k``).
    Returns ``(d2 (Q, k) ascending, idx (Q, k) int32, -1-padded)``."""
    q = queries.float()
    p = points.float()
    d2 = direct_d2(q[:, None, :], p[None, :, :])
    d2 = torch.where(ok[None, :], d2, BIG)
    n = p.shape[0]
    if k > n:   # fewer slots than k: pad with empty entries
        d2 = torch.cat([d2, torch.full((d2.shape[0], k - n), BIG,
                                       device=d2.device)], dim=1)
    idx = torch.argsort(d2, dim=1, stable=True)[:, :k]
    d2k = d2.gather(1, idx)
    return d2k, torch.where(d2k >= BIG, -1, idx.int())


def split_plan(Q: int, N: int, k: int, sms: int):
    """The flat kernel's grid: ``(threads, splits, per)`` -- threads a
    CTA (one a query: 128, or 32 when the top-k lives in shared memory),
    and the slots cut into ``splits`` ranges of ``per`` so that query
    tiles x splits reach ``CTAS_PER_SM`` CTAs on each of ``sms`` SMs
    (no range below 32 slots, at most ``MAX_SPLITS`` ranges)."""
    threads = 128 if k <= REG_K else 32
    q_tiles = max(1, -(-Q // threads))
    want = -(-CTAS_PER_SM * sms // q_tiles)
    per = split_size(N, min(want, max(1, -(-N // 32)), MAX_SPLITS))
    return threads, max(1, -(-N // per)), per


def _fn():
    lib = build.load("knn_flat")
    fn = _FNS.get(id(lib))
    if fn is None:
        fn = lib.knn_flat_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + \
            [ctypes.c_void_p] * 4
        _FNS[id(lib)] = fn
    return fn


def knn_flat(queries, points, ok, *, k: int):
    """Exact brute-force kNN of ``queries (Q, D)`` against ``points
    (N, D)`` with validity ``ok (N,)``; same contract as
    :func:`knn_flat_plain`. CUDA tensors launch the kernel, CPU tensors
    take the plain version."""
    dev = queries.device
    if dev.type == "cpu":
        return knn_flat_plain(queries, points, ok, k=k)
    if dev.type != "cuda":
        raise ValueError(f"knn_flat: unsupported device {dev}")
    Q, D = queries.shape
    N = points.shape[0]
    if points.device != dev or ok.device != dev:
        raise ValueError("knn_flat: queries, points and ok must share a "
                         "device")
    if points.shape[1] != D or ok.shape != (N,) or not 1 <= D <= 3:
        raise ValueError(f"knn_flat: bad shapes queries {tuple(queries.shape)}"
                         f" points {tuple(points.shape)} ok "
                         f"{tuple(ok.shape)} (D must be 1..3)")
    if ok.dtype != torch.bool:
        raise TypeError(f"knn_flat: ok must be bool, got {ok.dtype}")
    for name, t in (("queries", queries), ("points", points)):
        if t.dtype not in (torch.float32, torch.int32):
            raise TypeError(f"knn_flat: {name} must be float32 or int32, "
                            f"got {t.dtype}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn_flat: k={k} outside the kernel's 1..{MAX_K}")
    q = queries.float().contiguous()
    p = points.float().contiguous()
    okb = ok.contiguous().view(torch.uint8)
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    threads, splits, per = split_plan(Q, N, k, _SMS[dev.index])
    part = torch.empty((splits, Q, k), dtype=torch.int64, device=dev)
    out_d = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _fn()(q.data_ptr(), p.data_ptr(), okb.data_ptr(), Q, N, D, k,
                threads, splits, per, part.data_ptr(), out_d.data_ptr(),
                out_i.data_ptr(), stream)
    _STATS["launches"] += 1
    build.check(err, "knn_flat")
    return out_d, out_i
