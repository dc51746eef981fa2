"""Mamba-1's selective scan: the CUDA kernel ``csrc/selective_scan.cu``.

It replaces no TPU kernel: the reference leaves the scan to XLA
(``repro/models/ssm.py:_selective_scan`` and the ``C`` contraction of
``mamba_block``). :func:`selective_scan` launches the kernel for CUDA
tensors and takes :func:`ref.selective_scan_plain` for CPU tensors; any
other device raises. Each launch adds one to :func:`launch_count`. The
kernel has no backward: on a CUDA tensor that requires grad under grad
mode the wrapper raises (training the Mamba layers on the card waits
for a backward kernel, ROADMAP queue 1). The launch reads nothing back.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from .ref import selective_scan_plain

MAX_STATE = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_STATS = {"launches": 0}
_FN: list = []


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return _STATS["launches"]


def reset_launch_count() -> None:
    _STATS["launches"] = 0


def _fn():
    if not _FN:
        fn = build.load("selective_scan").selective_scan_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        _FN.append(fn)
    return _FN[0]


def _check(dt, xc, A, Bm, Cm, D_skip, h0):
    B, S, di = dt.shape
    ds = A.shape[-1]
    want = {"xc": (xc, (B, S, di), dt.dtype), "A": (A, (di, ds), None),
            "Bm": (Bm, (B, S, ds), dt.dtype), "Cm": (Cm, (B, S, ds), dt.dtype),
            "D_skip": (D_skip, (di,), None), "h0": (h0, (B, di, ds), None)}
    if dt.dtype not in _DTYPES:
        raise TypeError(f"selective_scan: dt must be float32 or bfloat16, "
                        f"got {dt.dtype}")
    for name, (t, shape, dtype) in want.items():
        dtype = dtype or torch.float32
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"selective_scan: {name} must be {shape} "
                             f"{dtype}, got {tuple(t.shape)} {t.dtype}")
        if t.device != dt.device:
            raise ValueError(f"selective_scan: {name} is on {t.device}, dt "
                             f"on {dt.device}")
    if not 1 <= ds <= MAX_STATE:
        raise ValueError(f"selective_scan: d_state {ds} not in 1..{MAX_STATE}")


def _aligned(t):
    """``t`` contiguous with a 16-byte aligned base (the kernel stages rows
    with 16-byte cp.async where their widths allow, and reads the state
    and ``A`` as float4)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def selective_scan(dt, xc, A, Bm, Cm, D_skip, h0, *, out_state=None):
    """:func:`ref.selective_scan_plain`'s function: ``(y, h_last)``. On the
    card ``out_state`` (B, di, ds) f32, when given, receives h_last (it
    may be ``h0`` itself: a cache updated in place) and is returned."""
    if dt.device.type == "cpu":
        y, h = selective_scan_plain(dt, xc, A, Bm, Cm, D_skip, h0)
        if out_state is not None:
            out_state.copy_(h)
            h = out_state
        return y, h
    if dt.device.type != "cuda":
        raise ValueError(f"selective_scan: unsupported device {dt.device}")
    _check(dt, xc, A, Bm, Cm, D_skip, h0)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (dt, xc, A, Bm, Cm, D_skip, h0)):
        raise NotImplementedError(
            "selective_scan: the CUDA kernel has no backward yet (ROADMAP "
            "queue 1: the recurrence kernels' backward)")
    B, S, di = dt.shape
    ds = A.shape[-1]
    if out_state is None:
        out_state = torch.empty((B, di, ds), dtype=torch.float32,
                                device=dt.device)
    elif (tuple(out_state.shape) != (B, di, ds)
          or out_state.dtype != torch.float32 or not out_state.is_contiguous()
          or out_state.data_ptr() % 16):
        raise ValueError("selective_scan: out_state must be a contiguous, "
                         f"16-byte aligned ({B}, {di}, {ds}) float32 tensor")
    args = [_aligned(t) for t in (dt, xc, A, Bm, Cm, D_skip)]
    h0 = h0 if h0.data_ptr() == out_state.data_ptr() else _aligned(h0)
    y = torch.empty((B, S, di), dtype=torch.float32, device=dt.device)
    stream = torch.cuda.current_stream(dt.device).cuda_stream
    err = _fn()(*(t.data_ptr() for t in args), h0.data_ptr(), y.data_ptr(),
                out_state.data_ptr(), _DTYPES[dt.dtype], B, S, di, ds,
                stream)
    _STATS["launches"] += 1
    build.check(err, "selective_scan")
    return y, out_state
