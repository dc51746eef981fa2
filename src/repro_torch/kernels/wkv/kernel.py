"""RWKV6's wkv recurrence: the CUDA kernels ``csrc/wkv6.cu`` (forward) and
``csrc/wkv6_bwd.cu`` (backward), and the autograd function that joins
them.

They replace no TPU kernel: the reference leaves the recurrence to XLA
(the ``lax.scan`` of ``repro/models/rwkv.py:time_mix``) and trains it
through XLA's autodiff. :func:`wkv6` launches the forward kernel for
CUDA tensors and takes :func:`ref.wkv6_plain` for CPU tensors; any other
device raises. :func:`wkv6_bwd` is the gradient: three launches for CUDA
tensors (the segments' local walks, the carry across segments, the main
backward; :func:`bwd_plan` gives the segments), the plain
:func:`ref.wkv6_bwd_plain` for CPU tensors. A build or launch error
raises; nothing falls back to a plain version on the card.

:func:`wkv6_train` is the training entry, a ``torch.autograd.Function``
(:class:`Wkv6`) whose forward is the forward kernel (the plain forward
on the CPU) and whose backward is :func:`wkv6_bwd`'s kernels (its plain
version on the CPU). :func:`wkv6` under grad mode with an input that
requires grad takes the same function (its last state takes no
gradient; an ``out_state`` updated in place is refused there on the
card).

:func:`launch_count` counts kernel launches: the forward's by default,
``"bwd"``, ``"bwd_local"`` and ``"bwd_carry"`` the backward's three
kernels. :func:`call_count` counts the autograd function's forward and
backward calls on any device. No launch reads anything back.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from .ref import wkv6_bwd_plain, wkv6_plain

HEAD_DIMS = (32, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_STATS = {"launches": 0, "bwd": 0, "bwd_local": 0, "bwd_carry": 0,
          "forward": 0, "backward": 0}
_CALLS = ("forward", "backward")
_FN: list = []
_BWD: list = []
_PLANS: dict = {}


def launch_count(kernel: str | None = None) -> int:
    """Kernel launches since the last :func:`reset_launch_count`: the
    forward kernel's, or those of ``kernel`` (``"bwd"``, ``"bwd_local"``,
    ``"bwd_carry"``)."""
    if kernel in _CALLS:
        raise ValueError(f"wkv6: {kernel!r} is a call count (call_count)")
    return _STATS["launches" if kernel is None else kernel]


def call_count(kind: str) -> int:
    """:class:`Wkv6`'s ``"forward"`` or ``"backward"`` calls since the last
    :func:`reset_launch_count`, on any device."""
    if kind not in _CALLS:
        raise ValueError(f"wkv6: no call count {kind!r}")
    return _STATS[kind]


def reset_launch_count() -> None:
    for key in _STATS:
        _STATS[key] = 0


def _fn():
    if not _FN:
        fn = build.load("wkv6").wkv6_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        _FN.append(fn)
    return _FN[0]


def _bwd_fn():
    """The backward's C entry points (launch, plan) and its checkpoint
    interval."""
    if not _BWD:
        lib = build.load("wkv6_bwd")
        fn = lib.wkv6_bwd_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        plan = lib.wkv6_bwd_plan
        plan.restype = ctypes.c_int
        plan.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.wkv6_bwd_chunk.restype = ctypes.c_int
        _BWD.append((fn, plan, lib.wkv6_bwd_chunk()))
    return _BWD[0]


def bwd_plan(dtype, B: int, S: int, H: int, hd: int, device) -> dict:
    """The backward's launch plan on the card for a shape, as its launcher
    computes it (cached): ``segment`` tokens a segment, ``segments``,
    ``chunk`` (tokens between checkpoints), ``resident`` CTAs an SM of its
    ``main``, ``local`` and ``carry`` kernels (the occupancy calculator),
    ``sms`` and each kernel's ``grid``."""
    device = torch.device(device)
    key = (dtype, B, S, H, hd, device.index)
    if key not in _PLANS:
        _, plan, chunk = _bwd_fn()
        out = (ctypes.c_int * 6)()
        with torch.cuda.device(device):
            err = plan(_DTYPES[dtype], B, S, H, hd, out)
        build.check(err, "wkv6 backward plan")
        nvb, n = hd // 32, out[1]
        _PLANS[key] = {
            "segment": out[0], "segments": n, "chunk": chunk,
            "resident": {"main": out[2], "local": out[3], "carry": out[4]},
            "sms": out[5],
            "grid": {"main": [H * nvb, n, B], "local": [H * nvb, n, B],
                     "carry": [H * nvb, B + 1]},
            "cluster": nvb}
    return _PLANS[key]


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


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def wkv6(r, k, v, w, u, state, *, out_state=None):
    """:func:`ref.wkv6_plain`'s function: ``(y, state)``. On the card
    ``out_state`` (B, H, hd, hd) f32, when given, receives the last state
    (it may be ``state`` itself: a cache updated in place) and is
    returned. Under grad mode with an input that requires grad and no
    ``out_state``, the call goes through :class:`Wkv6` (``y``
    differentiable, the last state not)."""
    if out_state is None and _needs_grad(r, k, v, w, u, state):
        return _apply(r, k, v, w, u, state)
    if r.device.type == "cpu":
        y, s = wkv6_plain(r, k, v, w, u, state)
        if out_state is not None:
            out_state.copy_(s)
            s = out_state
        return y, s
    if r.device.type != "cuda":
        raise ValueError(f"wkv6: unsupported device {r.device}")
    _check(r, k, v, w, u, state)
    if _needs_grad(r, k, v, w, u, state):
        raise ValueError("wkv6: under grad mode the last state cannot be "
                         "written in place (out_state); call without it")
    B, S, H, hd = r.shape
    if out_state is not None and (
            tuple(out_state.shape) != (B, H, hd, hd)
            or out_state.dtype != torch.float32
            or not out_state.is_contiguous() or out_state.data_ptr() % 16):
        raise ValueError(f"wkv6: out_state must be a contiguous, 16-byte "
                         f"aligned ({B}, {H}, {hd}, {hd}) float32 tensor")
    return _forward(r, k, v, w, u, state, out_state)


def _forward(r, k, v, w, u, state, out_state=None):
    """One launch of the forward kernel on checked CUDA inputs."""
    B, S, H, hd = r.shape
    if out_state is None:
        out_state = torch.empty((B, H, hd, hd), dtype=torch.float32,
                                device=r.device)
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


def wkv6_bwd(r, k, v, w, u, state, y_grad):
    """:func:`ref.wkv6_bwd_plain`'s function: the gradients ``(dr, dk, dv,
    dw, du, dstate)`` of :func:`wkv6`'s ``y`` given ``y_grad`` (B, S, H,
    hd) f32. For CUDA tensors, after checking them, the backward's three
    launches (:func:`bwd_plan`)."""
    if r.device.type == "cpu":
        return wkv6_bwd_plain(r, k, v, w, u, state, y_grad)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6: unsupported device {r.device}")
    _check(r, k, v, w, u, state)
    if (tuple(y_grad.shape) != tuple(r.shape)
            or y_grad.dtype != torch.float32 or y_grad.device != r.device):
        raise ValueError(f"wkv6: y_grad must be {tuple(r.shape)} float32 on "
                         f"{r.device}, got {tuple(y_grad.shape)} "
                         f"{y_grad.dtype} on {y_grad.device}")
    return _backward(r, k, v, w, u, state, y_grad)


def _backward(r, k, v, w, u, state, y_grad):
    """The backward's launches on checked CUDA inputs."""
    fn = _bwd_fn()[0]
    B, S, H, hd = r.shape
    plan = bwd_plan(r.dtype, B, S, H, hd, r.device)
    n = plan["segments"]
    nch = n * plan["segment"] // plan["chunk"]
    nvb = hd // 32
    f32 = {"dtype": torch.float32, "device": r.device}
    scratch = (torch.empty((B, H, nvb, nch, hd, 32), **f32),   # ckpt
               torch.empty((B, H, nch, hd), **f32),            # pre
               torch.empty((B, H, nvb, n, hd, 32), **f32),     # sloc
               torch.empty((B, H, nvb, n, hd, 32), **f32),     # gloc
               torch.empty((B, H, n, hd), **f32),              # dseg
               torch.empty((B, nvb, n, H, hd), **f32))         # du_part
    dr, dk, dv, dw = (torch.empty((B, S, H, hd), **f32) for _ in range(4))
    du = torch.empty((H, hd), **f32)
    dstate = torch.empty((B, H, hd, hd), **f32)
    args = [_aligned(t) for t in (r, k, v, w, u, state, y_grad)]
    stream = torch.cuda.current_stream(r.device).cuda_stream
    # the launcher's plan and shared-memory limit are the current device's
    with torch.cuda.device(r.device):
        err = fn(*(t.data_ptr() for t in (*args, *scratch, dr, dk, dv, dw,
                                           du, dstate)),
                 _DTYPES[r.dtype], B, S, H, hd, stream)
    _STATS["bwd_carry"] += 1
    if n:
        _STATS["bwd_local"] += 1
        _STATS["bwd"] += 1
    build.check(err, "wkv6 backward")
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw, du, dstate)


class Wkv6(torch.autograd.Function):
    """The wkv recurrence with :func:`wkv6_bwd` as its gradient: returns
    ``(y, last state)``, the state not differentiable. Inputs are checked
    by the caller, once a call."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        _STATS["forward"] += 1
        if r.device.type == "cpu":
            y, s = wkv6_plain(r, k, v, w, u, state)
        else:
            y, s = _forward(r, k, v, w, u, state)
        ctx.save_for_backward(r, k, v, w, u, state)
        ctx.mark_non_differentiable(s)
        return y, s

    @staticmethod
    def backward(ctx, y_grad, _state_grad):
        _STATS["backward"] += 1
        r, k, v, w, u, state = ctx.saved_tensors
        y_grad = y_grad.float()
        if r.device.type == "cpu":
            grads = wkv6_bwd_plain(r, k, v, w, u, state, y_grad)
        else:
            grads = _backward(r, k, v, w, u, state, y_grad)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def wkv6_train(r, k, v, w, u, state):
    """The training entry: :func:`wkv6`'s ``y`` through :class:`Wkv6`,
    differentiable in every input. The inputs are checked here (on the
    card), once a call."""
    return _apply(r, k, v, w, u, state)[0]


def _apply(r, k, v, w, u, state):
    if r.device.type == "cuda":
        _check(r, k, v, w, u, state)
    elif r.device.type != "cpu":
        raise ValueError(f"wkv6: unsupported device {r.device}")
    return Wkv6.apply(r, k, v, w, u, state)
