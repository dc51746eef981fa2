"""Fused frontier kNN: the CUDA kernel ``csrc/knn_frontier.cu`` and its
plain PyTorch versions.

Counterpart of ``repro/kernels/frontier/kernel.py:knn_frontier_pallas``.
Per query block the walk visits groups in ascending lower-bound order
(``prep.py``), keeps a running top-k per query, and stops at the first
group whose bound exceeds the block's worst k-th best distance -- the
prefix ``repro/kernels/frontier/ref.py`` visits. Distances are the
direct ``(q - p)^2`` form (``knn/ref.py``), read straight from the
tree's ``(R, C, D)`` points with validity ``valid & active``.

:func:`knn_frontier` launches the kernel for CUDA tensors and takes
:func:`knn_frontier_plain` for CPU tensors; each call that launches adds
one to :func:`launch_count` (the kernel is two launches: the split walk
and the merge). Both return ``(d2, ids, steps)``: ``(Qp, k)`` results in
sorted-query order (``ops.py`` undoes the sort) and a per-block step
count. :func:`knn_frontier_split_plain` spells the kernel's arithmetic
(the walk dealt to several walkers under a shared bound, merged by
``(d2, visit position)``) so the CPU tests can show the split changes no
bit.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from ..knn.ref import BIG, direct_d2, merge_topk
from .prep import FrontierPrep

MAX_K = 128   # a walker keeps k entries a query (registers to 12, then smem)
MAX_BLOCK_Q = 32   # one query a lane of a warp
MAX_GROUP = 512   # points a group: 16 flags a lane of a warp
EMPTY_POS = 2**31 - 1   # the visit position of an empty list entry

_STATS = {"launches": 0}
_WALKERS: dict = {}   # (library, device, pts_float, D, k, nqb) -> walkers


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


def knn_frontier_split_plain(pr: FrontierPrep, pts, valid, active, *,
                             k: int, splits: int):
    """The kernel's arithmetic, batched over query blocks: the visit
    sequence is dealt round-robin to ``splits`` walkers (round ``t``
    gives walker ``w`` visit position ``j = t * splits + w``), each keeps
    its own top-k keyed by ``(d2, pos)`` with ``pos = j * P + slot``, and
    every claim of a round is checked against the shared bound after the
    round before: the max over the block's queries of the min over
    walkers of their k-th best. A block stops after the first round with
    a failed claim. A candidate enters a walker's list only if its d2 is
    at most its query's published k-th (that min over walkers, from the
    round before): above it, k held points beat it. The walkers' lists
    are then merged by ``(d2, pos)`` and each ``pos`` mapped back to
    ``order[b, pos // P] * P + pos % P``.

    Returns ``(d2, ids, steps)`` like :func:`knn_frontier_plain`, with
    ``steps`` the groups each block's walk claimed (every group below it
    was scored or shown unable to hold a result by its bound); it is at
    least the plain walk's count."""
    R, C, D = pts.shape
    nqb, G = pr.order.shape
    bq, br, P = pr.block_q, pr.block_r, pr.points_per_group
    dev = pts.device
    qb = pr.qs.reshape(nqb, bq, D)
    dist = torch.full((nqb, splits, bq, k), BIG, device=dev)
    pos = torch.full((nqb, splits, bq, k), EMPTY_POS, dtype=torch.int64,
                     device=dev)
    walking = torch.ones(nqb, dtype=torch.bool, device=dev)
    steps = torch.zeros(nqb, dtype=torch.int64, device=dev)
    ok_rows = valid & active[:, None]
    slot = torch.arange(P, device=dev)
    for t in range(-(-G // splits)):
        j = t * splits + torch.arange(splits, device=dev)        # (splits,)
        jc = j.clamp(max=G - 1)
        pub = dist[..., k - 1].amin(dim=1)                       # (nqb, bq)
        bound = pub.amax(dim=1)                                  # (nqb,)
        live = walking[:, None] & (j < G) & \
            (pr.glb[:, jc] <= bound[:, None])                   # (nqb, S)
        steps = steps + walking.long() * (j < G).sum()
        walking = walking & live.all(dim=1)
        if not bool(live.any()):
            break
        g = pr.order[:, jc].long()                               # (nqb, S)
        rows = g[..., None] * br + torch.arange(br, device=dev)
        inside = rows < R
        rows = rows.clamp(max=R - 1)
        p = pts[rows].reshape(nqb, splits, P, D).float()
        ok = (ok_rows[rows] & inside[..., None]).reshape(nqb, splits, P)
        d2 = direct_d2(qb[:, None, :, None, :], p[:, :, None, :, :])
        d2 = torch.where(ok[:, :, None, :] & (d2 <= pub[:, None, :, None]),
                         d2, BIG)                          # (nqb, S, bq, P)
        # a walker's claims rise, so a tile's positions follow its list's
        nd, npos = merge_topk(dist, pos, d2, (j[:, None] * P + slot)[
            None, :, None, :], k)
        dist = torch.where(live[..., None, None], nd, dist)
        pos = torch.where(live[..., None, None], npos, pos)
    all_d = dist.transpose(1, 2).reshape(nqb, bq, splits * k)
    all_p = pos.transpose(1, 2).reshape(nqb, bq, splits * k)
    o = torch.argsort(all_p, dim=-1, stable=True)
    all_d, all_p = all_d.gather(-1, o), all_p.gather(-1, o)
    o = torch.argsort(all_d, dim=-1, stable=True)[..., :k]
    d2, pk = all_d.gather(-1, o), all_p.gather(-1, o)
    jj = (pk // P).clamp(max=G - 1)
    g = pr.order.long().gather(1, jj.reshape(nqb, -1)).reshape(jj.shape)
    ids = torch.where(d2 >= BIG, -1, g * P + pk % P).int()
    return d2.reshape(-1, k), ids.reshape(-1, k), steps.int()


def _lib():
    lib = build.load("knn_frontier")
    lib.knn_frontier_plan.restype = ctypes.c_int
    lib.knn_frontier_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn = lib.knn_frontier_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + \
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 6
    return lib


def _walkers(lib, pts_float: int, D: int, k: int, nqb: int) -> int:
    """The walkers a query block gets, from ``knn_frontier_plan`` once
    per library, device and shape (it depends on the card's occupancy
    only; the first call also sets the walk's shared-memory limit)."""
    key = (lib._handle, torch.cuda.current_device(), pts_float, D, k, nqb)
    if key not in _WALKERS:
        walkers = ctypes.c_int()
        build.check(lib.knn_frontier_plan(pts_float, D, k, nqb,
                                          ctypes.byref(walkers)),
                    "knn_frontier")
        _WALKERS[key] = walkers.value
    return _WALKERS[key]


def knn_frontier(pr: FrontierPrep, pts, valid, active, *, k: int):
    """Run the frontier walk over prepared operands. CUDA tensors launch
    the kernel, CPU tensors take :func:`knn_frontier_plain`.

    The kernel's ``(d2, ids)`` equal the plain walk's bit for bit, and two
    runs give the same bits. Its ``steps`` are the groups each block's walk
    claimed, scored or dismissed by the bound: at least the plain walk's
    count, and more by the claims of walkers running in parallel (how many
    more varies from run to run)."""
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
    if not 1 <= bq <= MAX_BLOCK_Q:
        raise ValueError(f"knn_frontier: block_q={bq} outside the kernel's "
                         f"1..{MAX_BLOCK_Q} (one query a lane)")
    if pr.points_per_group > MAX_GROUP:
        raise ValueError(f"knn_frontier: points_per_group="
                         f"{pr.points_per_group} above the kernel's "
                         f"{MAX_GROUP} (block_p)")
    if G * pr.points_per_group >= EMPTY_POS:
        raise ValueError("knn_frontier: G * points_per_group must stay "
                         "below 2^31 - 1 (visit positions are int32)")
    lib = _lib()
    pts_float = int(pts.dtype == torch.float32)
    walkers = _walkers(lib, pts_float, D, k, nqb)
    # zeroed: a cursor, a step count and 32 published k-th bests a block
    scratch = torch.zeros(nqb * 34, dtype=torch.int32, device=dev)
    wcount = torch.empty(nqb * walkers, dtype=torch.int32, device=dev)
    part = torch.empty(nqb * walkers * k * bq, dtype=torch.int64,
                       device=dev)
    out_d = torch.empty((nqb * bq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nqb * bq, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.knn_frontier_launch(
        pr.qs.data_ptr(), pts.data_ptr(), pts_float,
        valid.view(torch.uint8).data_ptr(),
        active.view(torch.uint8).data_ptr(), pr.order.data_ptr(),
        pr.glb.data_ptr(), R, C, D, G, pr.block_r, nqb, bq, k, walkers,
        scratch.data_ptr(), wcount.data_ptr(), part.data_ptr(),
        out_d.data_ptr(), out_i.data_ptr(), stream)
    _STATS["launches"] += 1
    build.check(err, "knn_frontier")
    return out_d, out_i, scratch[nqb:2 * nqb]
