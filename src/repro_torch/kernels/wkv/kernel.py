"""RWKV6's wkv recurrence: the CUDA kernel ``csrc/wkv6.cu``.

It replaces no TPU kernel: the reference leaves the recurrence to XLA
(the ``lax.scan`` of ``repro/models/rwkv.py:time_mix``). :func:`wkv6`
launches the kernel for CUDA tensors and takes :func:`ref.wkv6_plain`
for CPU tensors; any other device raises. Each launch adds one to
:func:`launch_count`. The kernel has no backward: on a CUDA tensor that
requires grad under grad mode the wrapper raises (training the RWKV
layers on the card waits for a backward kernel, ROADMAP queue 1). The
launch reads nothing back.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from .ref import wkv6_plain

HEAD_DIMS = (32, 64)
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
        fn = build.load("wkv6").wkv6_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        _FN.append(fn)
    return _FN[0]


def _check(r, k, v, w, u, state):
    B, S, H, hd = r.shape
    if r.dtype not in _DTYPES:
        raise TypeError(f"wkv6: r must be float32 or bfloat16, got {r.dtype}")
    want = {"k": (k, (B, S, H, hd), r.dtype), "v": (v, (B, S, H, hd), r.dtype),
            "w": (w, (B, S, H, hd), torch.float32),
            "u": (u, (H, hd), torch.float32),
            "state": (state, (B, H, hd, hd), torch.float32)}
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"wkv6: {name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != r.device:
            raise ValueError(f"wkv6: {name} is on {t.device}, r on "
                             f"{r.device}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"wkv6: head dim {hd} not one of {HEAD_DIMS}")


def _aligned(t):
    """``t`` contiguous with a 16-byte aligned base (the kernel copies rows
    with 16-byte cp.async and reads the state as float4)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def wkv6(r, k, v, w, u, state, *, out_state=None):
    """:func:`ref.wkv6_plain`'s function: ``(y, state)``. On the card
    ``out_state`` (B, H, hd, hd) f32, when given, receives the last state
    (it may be ``state`` itself: a cache updated in place) and is
    returned."""
    if r.device.type == "cpu":
        y, s = wkv6_plain(r, k, v, w, u, state)
        if out_state is not None:
            out_state.copy_(s)
            s = out_state
        return y, s
    if r.device.type != "cuda":
        raise ValueError(f"wkv6: unsupported device {r.device}")
    _check(r, k, v, w, u, state)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u, state)):
        raise NotImplementedError(
            "wkv6: the CUDA kernel has no backward yet (ROADMAP queue 1: "
            "the recurrence kernels' backward)")
    B, S, H, hd = r.shape
    if out_state is None:
        out_state = torch.empty((B, H, hd, hd), dtype=torch.float32,
                                device=r.device)
    elif (tuple(out_state.shape) != (B, H, hd, hd)
          or out_state.dtype != torch.float32 or not out_state.is_contiguous()
          or out_state.data_ptr() % 16):
        raise ValueError(f"wkv6: out_state must be a contiguous, 16-byte "
                         f"aligned ({B}, {H}, {hd}, {hd}) float32 tensor")
    args = [_aligned(t) for t in (r, k, v, w, u)]
    state = (state if state.data_ptr() == out_state.data_ptr()
             else _aligned(state))
    y = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = _fn()(*(t.data_ptr() for t in args), state.data_ptr(), y.data_ptr(),
                out_state.data_ptr(), _DTYPES[r.dtype], B, S, H, hd, stream)
    _STATS["launches"] += 1
    build.check(err, "wkv6")
    return y, out_state
