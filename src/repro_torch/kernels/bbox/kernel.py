"""Masked per-row bounding boxes: the CUDA kernel ``csrc/row_bbox.cu``.

Counterpart of ``repro/kernels/bbox/kernel.py:row_bbox_pallas``, with
the reference core path's contract (``ref.py``): the output keeps the
points' dtype. :func:`row_bbox` launches the kernel for CUDA tensors and
takes :func:`ref.row_bbox_plain` for CPU tensors; any other device
raises. Each launch adds one to :func:`launch_count`.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from .ref import row_bbox_plain

_STATS = {"launches": 0}


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return _STATS["launches"]


def reset_launch_count() -> None:
    _STATS["launches"] = 0


def _fn():
    fn = build.load("row_bbox").row_bbox_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return fn


def row_bbox(pts, valid):
    """(lo, hi) over the valid slots of each row of ``pts (R, C, D)``
    (int32 or float32) with ``valid (R, C)`` bool; same contract as
    :func:`ref.row_bbox_plain`."""
    dev = pts.device
    if dev.type == "cpu":
        return row_bbox_plain(pts, valid)
    if dev.type != "cuda":
        raise ValueError(f"row_bbox: unsupported device {dev}")
    if pts.dim() != 3 or not 1 <= pts.shape[2] <= 3:
        raise ValueError(f"row_bbox: pts must be (R, C, D) with D in 1..3, "
                         f"got {tuple(pts.shape)}")
    R, C, D = pts.shape
    if valid.device != dev:
        raise ValueError(f"row_bbox: valid is on {valid.device}, points "
                         f"on {dev}")
    if valid.shape != (R, C) or valid.dtype != torch.bool:
        raise ValueError(f"row_bbox: valid must be ({R}, {C}) bool, got "
                         f"{tuple(valid.shape)} {valid.dtype}")
    if pts.dtype not in (torch.int32, torch.float32):
        raise TypeError(f"row_bbox: points must be int32 or float32, got "
                        f"{pts.dtype}")
    p = pts.contiguous()
    v = valid.contiguous().view(torch.uint8)
    lo = torch.empty((R, D), dtype=pts.dtype, device=dev)
    hi = torch.empty((R, D), dtype=pts.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _fn()(p.data_ptr(), v.data_ptr(), int(pts.dtype == torch.float32),
                R, C, D, lo.data_ptr(), hi.data_ptr(), stream)
    _STATS["launches"] += 1
    build.check(err, "row_bbox")
    return lo, hi
