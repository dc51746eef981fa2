"""Morton encode: the CUDA kernel ``csrc/morton.cu``.

Counterpart of ``repro/kernels/morton/kernel.py:morton_encode_pallas``.
:func:`morton_encode` launches the kernel for CUDA tensors and takes
:func:`ref.morton_encode_plain` for CPU tensors; any other device
raises. Each launch adds one to :func:`launch_count`. The launch reads
nothing back, so an insert that encodes stays free of host syncs.
"""

from __future__ import annotations

import ctypes

import torch

from ...core import sfc
from .. import build
from .ref import morton_encode_plain

_STATS = {"launches": 0}


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return _STATS["launches"]


def reset_launch_count() -> None:
    _STATS["launches"] = 0


def _fn():
    fn = build.load("morton").morton_encode_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    return fn


def morton_encode(pts, *, bits: int, coord_bits: int):
    """(N, D) points -> (N,) int64 Morton codes of ``pts >> max(0,
    coord_bits - bits)``; same contract as :func:`ref.morton_encode_plain`
    (codes of at most 32 bits: ``bits * D <= 32``)."""
    dev = pts.device
    if dev.type == "cpu":
        return morton_encode_plain(pts, bits=bits, coord_bits=coord_bits)
    if dev.type != "cuda":
        raise ValueError(f"morton_encode: unsupported device {dev}")
    if pts.dim() != 2 or pts.shape[1] < 1:
        raise ValueError(f"morton_encode: pts must be (N, D), got "
                         f"{tuple(pts.shape)}")
    n, dim = pts.shape
    sfc._check_width(dim, bits)
    if pts.dtype != torch.int32:
        # the plain version's cast, kept as the same 32 bits
        pts = sfc._as_code(pts).to(torch.int32)
    p = pts.contiguous()
    out = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return out
    shift = max(0, coord_bits - bits)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _fn()(p.data_ptr(), n, dim, bits, shift, out.data_ptr(), stream)
    _STATS["launches"] += 1
    build.check(err, "morton_encode")
    return out
