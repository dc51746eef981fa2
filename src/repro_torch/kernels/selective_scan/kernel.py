"""Mamba-1's selective scan: the CUDA kernels ``csrc/selective_scan.cu``
(forward) and ``csrc/selective_scan_bwd.cu`` (backward), and the
autograd function that joins them.

They replace no TPU kernel: the reference leaves the scan to XLA
(``repro/models/ssm.py:_selective_scan`` and the ``C`` contraction of
``mamba_block``) and trains it through XLA's autodiff.
:func:`selective_scan` launches the forward kernel for CUDA tensors and
takes :func:`ref.selective_scan_plain` for CPU tensors; any other device
raises. :func:`selective_scan_bwd` is the gradient: three launches for
CUDA tensors (the checkpoints, the backward and the reduction of its
partials), the plain
:func:`ref.selective_scan_bwd_plain` for CPU tensors. A build or launch
error raises; nothing falls back to a plain version on the card.

:func:`selective_scan_train` is the training entry, a
``torch.autograd.Function`` (:class:`SelectiveScan`) whose forward is the
forward kernel (the plain forward on the CPU) and whose backward is
:func:`selective_scan_bwd`'s kernels (its plain version on the CPU).
:func:`selective_scan` under grad mode with an input that requires grad
takes the same function (its last state takes no gradient; an
``out_state`` updated in place is refused there on the card).

:func:`launch_count` counts kernel launches: the forward's by default,
``"bwd_ckpt"``, ``"bwd"`` and ``"bwd_reduce"`` the backward's three
kernels.
:func:`call_count` counts the autograd function's forward and backward
calls on any device. No launch reads anything back.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from .ref import selective_scan_bwd_plain, selective_scan_plain

MAX_STATE = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_STATS = {"launches": 0, "bwd_ckpt": 0, "bwd": 0, "bwd_reduce": 0,
          "forward": 0, "backward": 0}
_CALLS = ("forward", "backward")
_FN: list = []
_BWD: list = []


def launch_count(kernel: str | None = None) -> int:
    """Kernel launches since the last :func:`reset_launch_count`: the
    forward kernel's, or those of ``kernel`` (``"bwd_ckpt"``, ``"bwd"``,
    ``"bwd_reduce"``)."""
    if kernel in _CALLS:
        raise ValueError(f"selective_scan: {kernel!r} is a call count "
                         f"(call_count)")
    return _STATS["launches" if kernel is None else kernel]


def call_count(kind: str) -> int:
    """:class:`SelectiveScan`'s ``"forward"`` or ``"backward"`` calls since
    the last :func:`reset_launch_count`, on any device."""
    if kind not in _CALLS:
        raise ValueError(f"selective_scan: no call count {kind!r}")
    return _STATS[kind]


def reset_launch_count() -> None:
    for key in _STATS:
        _STATS[key] = 0


def _fn():
    if not _FN:
        fn = build.load("selective_scan").selective_scan_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        _FN.append(fn)
    return _FN[0]


def _bwd_fn():
    """The backward's C entry point, its checkpoint interval, its channels
    a CTA and its occupancy query."""
    if not _BWD:
        lib = build.load("selective_scan_bwd")
        fn = lib.selective_scan_bwd_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        lib.selective_scan_bwd_chunk.restype = ctypes.c_int
        lib.selective_scan_bwd_channels.restype = ctypes.c_int
        resident = lib.selective_scan_bwd_resident
        resident.restype = ctypes.c_int
        resident.argtypes = [ctypes.c_int, ctypes.c_int]
        _BWD.append((fn, lib.selective_scan_bwd_chunk(),
                     lib.selective_scan_bwd_channels(), resident))
    return _BWD[0]


def bwd_plan(dtype, B: int, S: int, di: int, device) -> dict:
    """The backward's launches on the card for a shape: ``chunk`` (tokens
    between checkpoints), ``channels`` a CTA, the ``grid`` (the checkpoint
    and backward kernels') and the ``resident`` CTAs an SM of the
    ``main`` and ``ckpt`` kernels (the occupancy calculator)."""
    _, chunk, width, resident = _bwd_fn()
    with torch.cuda.device(torch.device(device)):
        n = {"main": resident(_DTYPES[dtype], 0),
             "ckpt": resident(_DTYPES[dtype], 1)}
    for v in n.values():
        if v < 0:
            build.check(-v, "selective_scan backward occupancy")
    return {"chunk": chunk, "channels": width, "checkpoints": -(-S // chunk),
            "grid": [-(-di // width), B], "resident": n}


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


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def selective_scan(dt, xc, A, Bm, Cm, D_skip, h0, *, out_state=None):
    """:func:`ref.selective_scan_plain`'s function: ``(y, h_last)``. On the
    card ``out_state`` (B, di, ds) f32, when given, receives h_last (it
    may be ``h0`` itself: a cache updated in place) and is returned.
    Under grad mode with an input that requires grad and no
    ``out_state``, the call goes through :class:`SelectiveScan` (``y``
    differentiable, ``h_last`` not)."""
    ins = (dt, xc, A, Bm, Cm, D_skip, h0)
    if out_state is None and _needs_grad(*ins):
        return _apply(*ins)
    if dt.device.type == "cpu":
        y, h = selective_scan_plain(*ins)
        if out_state is not None:
            out_state.copy_(h)
            h = out_state
        return y, h
    if dt.device.type != "cuda":
        raise ValueError(f"selective_scan: unsupported device {dt.device}")
    _check(*ins)
    if _needs_grad(*ins):
        raise ValueError("selective_scan: under grad mode the last state "
                         "cannot be written in place (out_state); call "
                         "without it")
    B, S, di = dt.shape
    ds = A.shape[-1]
    if out_state is not None and (
            tuple(out_state.shape) != (B, di, ds)
            or out_state.dtype != torch.float32
            or not out_state.is_contiguous() or out_state.data_ptr() % 16):
        raise ValueError("selective_scan: out_state must be a contiguous, "
                         f"16-byte aligned ({B}, {di}, {ds}) float32 tensor")
    return _forward(*ins, out_state)


def _forward(dt, xc, A, Bm, Cm, D_skip, h0, out_state=None):
    """One launch of the forward kernel on checked CUDA inputs."""
    B, S, di = dt.shape
    ds = A.shape[-1]
    if out_state is None:
        out_state = torch.empty((B, di, ds), dtype=torch.float32,
                                device=dt.device)
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


def selective_scan_bwd(dt, xc, A, Bm, Cm, D_skip, h0, y_grad):
    """:func:`ref.selective_scan_bwd_plain`'s function: the gradients
    ``(ddt, dxc, dA, dBm, dCm, dD, dh0)`` of :func:`selective_scan`'s
    ``y`` given ``y_grad`` (B, S, di) f32. For CUDA tensors, after
    checking them, the checkpoint kernel, the backward kernel and the
    reduction of its partials (three launches)."""
    if dt.device.type == "cpu":
        return selective_scan_bwd_plain(dt, xc, A, Bm, Cm, D_skip, h0,
                                        y_grad)
    if dt.device.type != "cuda":
        raise ValueError(f"selective_scan: unsupported device {dt.device}")
    _check(dt, xc, A, Bm, Cm, D_skip, h0)
    if (tuple(y_grad.shape) != tuple(dt.shape)
            or y_grad.dtype != torch.float32 or y_grad.device != dt.device):
        raise ValueError(f"selective_scan: y_grad must be {tuple(dt.shape)} "
                         f"float32 on {dt.device}, got "
                         f"{tuple(y_grad.shape)} {y_grad.dtype} on "
                         f"{y_grad.device}")
    return _backward(dt, xc, A, Bm, Cm, D_skip, h0, y_grad)


def _backward(dt, xc, A, Bm, Cm, D_skip, h0, y_grad):
    """The backward's three launches on checked CUDA inputs."""
    fn, chunk, width, _ = _bwd_fn()
    B, S, di = dt.shape
    ds = A.shape[-1]
    f32 = {"dtype": torch.float32, "device": dt.device}
    nb = -(-di // width)
    ckpt = torch.empty((B, -(-S // chunk), nb * width, MAX_STATE), **f32)
    bc_part = torch.empty((2, nb, B, S, ds), **f32)
    da_part = torch.empty((B, di, ds), **f32)
    dd_part = torch.empty((B, di), **f32)
    ddt, dx = (torch.empty((B, S, di), **f32) for _ in range(2))
    dA = torch.empty((di, ds), **f32)
    dB, dC = (torch.empty((B, S, ds), **f32) for _ in range(2))
    dD = torch.empty((di,), **f32)
    dh0 = torch.empty((B, di, ds), **f32)
    args = [_aligned(t) for t in (dt, xc, A, Bm, Cm, D_skip, h0, y_grad)]
    stream = torch.cuda.current_stream(dt.device).cuda_stream
    err = fn(*(t.data_ptr() for t in (*args, ckpt, bc_part[0], bc_part[1],
                                       da_part, dd_part, ddt, dx, dA, dB, dC,
                                       dD, dh0)),
             _DTYPES[dt.dtype], B, S, di, ds, stream)
    _STATS["bwd_ckpt"] += 1
    _STATS["bwd"] += 1
    _STATS["bwd_reduce"] += 1
    build.check(err, "selective_scan backward")
    return (ddt.to(dt.dtype), dx.to(xc.dtype), dA, dB.to(Bm.dtype),
            dC.to(Cm.dtype), dD, dh0)


class SelectiveScan(torch.autograd.Function):
    """The selective scan with :func:`selective_scan_bwd` as its gradient:
    returns ``(y, h_last)``, ``h_last`` not differentiable. Inputs are
    checked by the caller, once a call."""

    @staticmethod
    def forward(ctx, dt, xc, A, Bm, Cm, D_skip, h0):
        _STATS["forward"] += 1
        ins = (dt, xc, A, Bm, Cm, D_skip, h0)
        if dt.device.type == "cpu":
            y, h = selective_scan_plain(*ins)
        else:
            y, h = _forward(*ins)
        ctx.save_for_backward(*ins)
        ctx.mark_non_differentiable(h)
        return y, h

    @staticmethod
    def backward(ctx, y_grad, _h_grad):
        _STATS["backward"] += 1
        ins = ctx.saved_tensors
        y_grad = y_grad.float()
        if ins[0].device.type == "cpu":
            grads = selective_scan_bwd_plain(*ins, y_grad)
        else:
            grads = _backward(*ins, y_grad)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def selective_scan_train(dt, xc, A, Bm, Cm, D_skip, h0):
    """The training entry: :func:`selective_scan`'s ``y`` through
    :class:`SelectiveScan`, differentiable in every input. The inputs are
    checked here (on the card), once a call."""
    return _apply(dt, xc, A, Bm, Cm, D_skip, h0)[0]


def _apply(*ins):
    if ins[0].device.type == "cuda":
        _check(*ins)
    elif ins[0].device.type != "cpu":
        raise ValueError(f"selective_scan: unsupported device "
                         f"{ins[0].device}")
    return SelectiveScan.apply(*ins)
