"""Fused frontier kNN: the CUDA kernel ``csrc/knn_frontier.cu`` and its
plain PyTorch version.

Counterpart of ``repro/kernels/frontier/kernel.py:knn_frontier_pallas``.
Per query block the walk visits groups in ascending lower-bound order
(``prep.py``), keeps a running top-k per query, and stops at the first
group whose bound exceeds the block's worst k-th best distance -- the
prefix ``repro/kernels/frontier/ref.py`` visits. Distances are the
direct ``(q - p)^2`` form (``knn/ref.py``), read straight from the
tree's ``(R, C, D)`` points with validity ``valid & active``.

:func:`knn_frontier` launches the kernel for CUDA tensors and takes
:func:`knn_frontier_plain` for CPU tensors; each launch adds one to
:func:`launch_count`. Both return ``(d2, ids, steps)``: ``(Qp, k)``
results in sorted-query order (``ops.py`` undoes the sort) and the
number of groups each query block visited.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from ..knn.ref import BIG, direct_d2, merge_topk
from .prep import FrontierPrep

MAX_K = 128   # the kernel keeps k running entries per thread in smem
MAX_SMEM = 227 * 1024

_STATS = {"launches": 0}


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return _STATS["launches"]


def reset_launch_count() -> None:
    _STATS["launches"] = 0


def knn_frontier_plain(pr: FrontierPrep, pts, valid, active, *, k: int):
    """The reference walk, batched over query blocks: step ``j`` scores
    group ``order[b, j]`` for every block still walking, and a block
    stops at its first bound above its worst k-th best."""
    R, C, D = pts.shape
    nqb, G = pr.order.shape
    bq, br, P = pr.block_q, pr.block_r, pr.points_per_group
    dev = pts.device
    qb = pr.qs.reshape(nqb, bq, D)
    dist = torch.full((nqb, bq, k), BIG, device=dev)
    idx = torch.full((nqb, bq, k), -1, dtype=torch.int32, device=dev)
    walking = torch.ones(nqb, dtype=torch.bool, device=dev)
    steps = torch.zeros(nqb, dtype=torch.int32, device=dev)
    ok_rows = valid & active[:, None]
    slot = torch.arange(P, device=dev)
    for j in range(G):
        walking = walking & (pr.glb[:, j] <= dist[:, :, k - 1].amax(dim=1))
        if not bool(walking.any()):
            break
        g = pr.order[:, j].long()                              # (nqb,)
        rows = g[:, None] * br + torch.arange(br, device=dev)  # (nqb, br)
        inside = rows < R
        rows = rows.clamp(max=R - 1)
        p = pts[rows].reshape(nqb, P, D).float()
        ok = (ok_rows[rows] & inside[:, :, None]).reshape(nqb, P)
        d2 = direct_d2(qb[:, :, None, :], p[:, None, :, :])   # (nqb, bq, P)
        d2 = torch.where(ok[:, None, :], d2, BIG)
        ids = (g[:, None] * P + slot).int()[:, None, :]
        nd, ni = merge_topk(dist, idx, d2, ids, k)
        dist = torch.where(walking[:, None, None], nd, dist)
        idx = torch.where(walking[:, None, None], ni, idx)
        steps = steps + walking.int()
    idx = torch.where(dist >= BIG, -1, idx)
    return dist.reshape(-1, k), idx.reshape(-1, k), steps


def _fn():
    fn = build.load("knn_frontier").knn_frontier_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + \
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 4
    return fn


def knn_frontier(pr: FrontierPrep, pts, valid, active, *, k: int):
    """Run the frontier walk over prepared operands; same contract as
    :func:`knn_frontier_plain`. CUDA tensors launch the kernel, CPU
    tensors take the plain version."""
    dev = pts.device
    if dev.type == "cpu":
        return knn_frontier_plain(pr, pts, valid, active, k=k)
    if dev.type != "cuda":
        raise ValueError(f"knn_frontier: unsupported device {dev}")
    R, C, D = pts.shape
    nqb, G = pr.order.shape
    bq = pr.block_q
    for name, t in (("valid", valid), ("active", active), ("qs", pr.qs),
                    ("order", pr.order), ("glb", pr.glb)):
        if t.device != dev:
            raise ValueError(f"knn_frontier: {name} is on {t.device}, "
                             f"points on {dev}")
    if valid.shape != (R, C) or active.shape != (R,) or \
            pr.qs.shape != (nqb * bq, D) or pr.glb.shape != (nqb, G) or \
            not 1 <= D <= 3 or G != -(-R // pr.block_r):
        raise ValueError("knn_frontier: operand shapes do not match the "
                         "prep (D must be 1..3)")
    if pts.dtype not in (torch.int32, torch.float32) or \
            valid.dtype != torch.bool or active.dtype != torch.bool or \
            pr.qs.dtype != torch.float32 or pr.order.dtype != torch.int32 \
            or pr.glb.dtype != torch.float32:
        raise TypeError("knn_frontier: expected int32/float32 points, bool "
                        "masks, f32 queries/bounds and int32 order")
    if not all(t.is_contiguous() for t in (pts, valid, active, pr.qs,
                                           pr.order, pr.glb)):
        raise ValueError("knn_frontier: operands must be contiguous")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn_frontier: k={k} outside the kernel's "
                         f"1..{MAX_K}")
    if not 1 <= bq <= 1024 or 8 * k * bq + 256 * 13 > MAX_SMEM:
        raise ValueError(f"knn_frontier: block_q={bq} with k={k} does not "
                         f"fit one CUDA block")
    out_d = torch.empty((nqb * bq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nqb * bq, k), dtype=torch.int32, device=dev)
    steps = torch.empty(nqb, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _fn()(pr.qs.data_ptr(), pts.data_ptr(),
                int(pts.dtype == torch.float32),
                valid.view(torch.uint8).data_ptr(),
                active.view(torch.uint8).data_ptr(), pr.order.data_ptr(),
                pr.glb.data_ptr(), R, C, D, G, pr.block_r, nqb, bq, k,
                out_d.data_ptr(), out_i.data_ptr(), steps.data_ptr(), stream)
    _STATS["launches"] += 1
    build.check(err, "knn_frontier")
    return out_d, out_i, steps
