"""Flash attention: the CUDA kernel ``csrc/flash_attn.cu``.

Counterpart of ``repro/kernels/flash_attn/kernel.py:flash_attention``,
widened to the function of the reference models' jnp twin
(``repro/models/layers.py:_chunk_attention``): queries at ``q_offset +
i``, kv slots at explicit positions ``k_pos`` (-1 = empty). The contract
is :func:`ref.attention_plain`'s. :func:`flash_attention` launches the
kernel for CUDA tensors and takes the plain version for CPU tensors; any
other device raises. Each launch adds one to :func:`launch_count`.

Only the last dimension of q, k and v must be contiguous: a cache's
valid prefix ``cache[:, :, :n]`` and the ``transpose(1, 2)`` of a
projection go in as they are. The output is allocated as ``(B, Sq, Hq,
d)`` and returned as its ``(B, Hq, Sq, d)`` view, so the caller's
transpose back to ``(B, S, H, d)`` is contiguous. The launch reads
nothing back.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from .ref import attention_plain

MAX_D = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_STATS = {"launches": 0}


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return _STATS["launches"]


def reset_launch_count() -> None:
    _STATS["launches"] = 0


def _fn():
    fn = build.load("flash_attn").flash_attn_launch
    fn.restype = ctypes.c_int
    ll, i = ctypes.c_longlong, ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [i] * 7 + [ll] * 12
                   + [i, i, i, ctypes.c_float, ctypes.c_void_p])
    return fn


def _check(q, k, v, window, k_pos):
    dev = q.device
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"attention: q must be (B, Hq, Sq, d) and k, v "
                         f"(B, Hkv, Skv, d), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, _, d = q.shape
    if k.shape[0] != B or k.shape[3] != d or Hq % k.shape[1]:
        raise ValueError(f"attention: k, v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention: q, k, v must all be float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d > MAX_D:
        raise ValueError(f"attention: head dim {d} above {MAX_D}")
    if window is not None and window < 1:
        raise ValueError(f"attention: window must be >= 1, got {window}")
    others = {"k": k, "v": v, "k_pos": k_pos}
    for name, t in others.items():
        if t is not None and t.device != dev:
            raise ValueError(f"attention: {name} is on {t.device}, q on "
                             f"{dev}")
    if k_pos is not None and (k_pos.shape != (k.shape[2],)
                              or k_pos.dtype != torch.int32):
        raise ValueError(f"attention: k_pos must be ({k.shape[2]},) int32, "
                         f"got {tuple(k_pos.shape)} {k_pos.dtype}")


def _inner(t):
    """``t`` itself when its last dimension is contiguous, else a copy."""
    return t if t.stride(-1) == 1 else t.contiguous()


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    q_offset=None, k_pos=None):
    """q: (B, Hq, Sq, d), k/v: (B, Hkv, Skv, d) -> (B, Hq, Sq, d) in
    ``q.dtype``; the contract of :func:`ref.attention_plain` (``q_offset
    = None``: the queries are the kv sequence's suffix). f32 or bf16,
    d <= 256."""
    dev = q.device
    if dev.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, k_pos=k_pos)
    if dev.type != "cuda":
        raise ValueError(f"attention: unsupported device {dev}")
    _check(q, k, v, window, k_pos)
    B, Hq, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if q_offset is None:
        q_offset = Skv - Sq
    q, k, v = _inner(q), _inner(k), _inner(v)
    out = torch.empty((B, Sq, Hq, d), dtype=q.dtype,
                      device=dev).transpose(1, 2)
    if k_pos is not None:
        k_pos = k_pos.contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if k_pos is None else k_pos.data_ptr(),
                _DTYPES[q.dtype], B, Hq, Hkv, Sq, Skv, d,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *out.stride()[:3], int(q_offset), int(causal),
                0 if window is None else int(window), 1.0 / (d ** 0.5),
                stream)
    _STATS["launches"] += 1
    build.check(err, "flash_attention")
    return out
