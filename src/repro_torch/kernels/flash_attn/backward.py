"""The backward of flash attention: the CUDA kernels of
``csrc/flash_attn_bwd.cu`` and the autograd function of the training
form.

:func:`attention_bwd` takes the forward's inputs, output and row
log-sum-exp (:func:`kernel.flash_attention_lse`) and the output's
gradient, and returns ``(dq, dk, dv)``: three launches for CUDA tensors
(``delta``, then ``dkdv`` and ``dq``; each adds one to
:func:`launch_count` and to ``launch_count(kernel)``), the plain version
:func:`ref.attention_bwd_plain` for CPU tensors; any other device
raises, and so does a build or launch error. :func:`variant_for` picks
dkdv's and dq's variant before any launch: ``tc`` for bf16 with the
forward's tc head widths and 16-byte aligned rows, ``simt`` for the
rest; each call adds one to ``launch_count(variant)``.

``tc`` is Hopper's design: a CTA of two consumer warpgroups and a
producer warp, 64-row tiles brought by TMA into a shared-memory ring on
mbarriers, every product a ``wgmma`` (dkdv: 128 kv rows resident, the
query tiles of the group's q heads streamed; dq: 128 query rows
resident, the kv tiles streamed), p and dS carried into the value
products as bf16 hi + lo. It replaced a first version on ``mma.sync``
fed by ``cp.async`` that took 3.1x the time of PyTorch's own attention
backward at the training layer; the products bound it, at 20 d
operations a visible pair against the function's 10 d (the source's
note). Its arithmetic's CPU mirror is
:func:`ref.attention_bwd_tc_plain`. The tensor maps TMA reads are made
on the host for each call from the views' pointers and strides; a view
with a zero stride is copied first.

The reference has no ``custom_vjp``: XLA differentiates its jnp twin
(``repro/models/layers.py:_chunk_attention``), and the tests hold these
gradients against ``jax.vjp`` of it.

:func:`flash_attention_train` is the training forms of
:func:`kernel.flash_attention` as a ``torch.autograd.Function``: self
attention (``Sq == Skv``, causal or not, a window) and cross attention
(``Sq != Skv``, non-causal, no window: the encoder-decoder's), the
queries at ``q_offset`` 0 and no ``k_pos``, grouped-query heads, f32 or
bf16, d a multiple of 16 up to 128. Its forward saves ``(q, k, v, out,
lse)``, its backward is :func:`attention_bwd`. The models take it when
grad mode is on and an input requires grad
(``models/layers.py:_chunk_attention``).
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from . import kernel as fak
from .ref import attention_bwd_plain

KERNELS = ("delta", "dkdv", "dq")
VARIANTS = ("tc", "simt")
_ENTRY = {name: f"flash_attn_bwd_{name}_launch" for name in KERNELS}
_STATS = dict.fromkeys(("launches", *KERNELS, *VARIANTS), 0)
_FNS: dict = {}


def launch_count(kernel: str | None = None) -> int:
    """Kernel launches since the last :func:`reset_launch_count` (of
    ``kernel`` alone when named; a variant's count is wrapper calls)."""
    return _STATS["launches" if kernel is None else kernel]


def reset_launch_count() -> None:
    for key in _STATS:
        _STATS[key] = 0


def _fn(name: str):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(build.load("flash_attn_bwd"), _ENTRY[name])
        fn.restype = ctypes.c_int
        i = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 10
                       + [ctypes.POINTER(ctypes.c_longlong)] + [i] * 9
                       + [ctypes.c_float, i, ctypes.c_void_p])
        _FNS[name] = fn
    return fn


def _grad_like(t):
    """An uninitialised gradient for ``t`` (B, H, S, d) at ``t``'s own
    length S (q's Sq, k's and v's Skv), laid out as ``(B, S, H, d)``
    memory like the models' q, k and v views."""
    B, H, S, d = t.shape
    return torch.empty((B, S, H, d), dtype=t.dtype,
                       device=t.device).transpose(1, 2)


def _strided(t):
    """``t`` itself unless a dimension of more than one element has
    stride 0 (a broadcast, which a tensor map cannot step over): then a
    contiguous copy."""
    if any(st == 0 and n > 1 for st, n in zip(t.stride(), t.shape)):
        return t.contiguous()
    return t


def variant_for(q, k, v, o, do) -> str:
    """``"tc"`` for bf16 inputs of a tensor-core head width whose rows
    ``cp.async`` can load (:func:`kernel.variant_for`'s rule), else
    ``"simt"``; decided from dtype, shapes and strides alone."""
    if (q.dtype == torch.bfloat16 and q.shape[3] in fak.TC_DIMS
            and all(fak._rows_aligned(t) for t in (q, k, v, o, do))):
        return "tc"
    return "simt"


def attention_bwd(q, k, v, o, lse, do, *, causal: bool = True, window=None,
                  variant: str | None = None):
    """``(dq, dk, dv)`` of a training-form attention at ``do``, from the
    forward's output ``o`` and row log-sum-exp ``lse`` (B, Hq, Sq) f32;
    the contract of :func:`ref.attention_bwd_plain` at ``q_offset`` 0
    (Sq != Skv only non-causal without a window). Each gradient has its
    input's shape and dtype. ``variant`` names one for tests and
    measurements (``simt`` takes all CUDA inputs, ``tc`` what
    :func:`variant_for` gives it); the models leave it to
    :func:`variant_for`."""
    fak.check_train(q, k, v, causal, window)
    if o.shape != q.shape or do.shape != q.shape or \
            lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError(f"attention_bwd: o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)} must be q's {tuple(q.shape)}, "
                         f"lse {tuple(lse.shape)} {lse.dtype} f32 "
                         f"{tuple(q.shape[:3])}")
    dev = q.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"attention_bwd: unsupported device {dev}")
    if any(t.device != dev for t in (o, lse, do)):
        raise ValueError("attention_bwd: o, lse and do must be on q's device")
    return _backward(q, k, v, o, lse, do, causal, window, variant)


def _backward(q, k, v, o, lse, do, causal, window, variant=None):
    """:func:`attention_bwd` on inputs already checked (the autograd
    function's call: its forward checked q, k and v, and o, lse and do
    have their shapes by construction)."""
    dev = q.device
    if dev.type == "cpu":
        return attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                   window=window, q_offset=0)
    B, Hq, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    q, k, v, o, do = (_strided(fak._inner(t.to(q.dtype)))
                      for t in (q, k, v, o, do))
    lse = lse.contiguous()
    fits = variant_for(q, k, v, o, do)
    if variant is None:
        variant = fits
    elif variant not in VARIANTS or variant not in ("simt", fits):
        raise ValueError(f"attention_bwd: the {variant!r} variant does not "
                         f"take q {tuple(q.shape)} {q.dtype}")
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=dev)
    dq, dk, dv = _grad_like(q), _grad_like(k), _grad_like(v)
    strides = (ctypes.c_longlong * 24)(*(
        st for t in (q, k, v, o, do, dq, dk, dv) for st in t.stride()[:3]))
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), strides, fak._DTYPES[q.dtype], B,
            Hq, Hkv, Sq, Skv, d, int(causal),
            0 if window is None else int(window),
            1.0 / (d ** 0.5), int(variant == "tc"),
            torch.cuda.current_stream(dev).cuda_stream]
    _STATS[variant] += 1
    for name in KERNELS:
        err = _fn(name)(*args)
        _STATS["launches"] += 1
        _STATS[name] += 1
        build.check(err, f"flash_attention backward ({name}, {variant})")
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Training-form attention with the backward kernels as its
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = fak._forward_lse(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, do, ctx.causal,
                               ctx.window)
        return dq, dk, dv, None, None


def flash_attention_train(q, k, v, *, causal: bool = True, window=None):
    """:func:`kernel.flash_attention` in a training form (self attention,
    or cross attention at Sq != Skv: non-causal, no window; queries at
    ``q_offset`` 0), differentiable through :func:`attention_bwd`. The
    inputs are checked here, once a call; the forward and backward launch
    without checking them again."""
    fak.check_train(q, k, v, causal, window)
    return FlashAttention.apply(q, k, v, causal, window)
