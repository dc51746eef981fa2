"""Flash attention: the CUDA kernels of ``csrc/flash_attn.cu``.

Counterpart of ``repro/kernels/flash_attn/kernel.py:flash_attention``,
widened to the function of the reference models' jnp twin
(``repro/models/layers.py:_chunk_attention``): queries at ``q_offset +
i``, kv slots at explicit positions ``k_pos`` (-1 = empty). The contract
is :func:`ref.attention_plain`'s. :func:`flash_attention` launches a
kernel for CUDA tensors and takes the plain version for CPU tensors; any
other device raises.

Three variants compute that one function; :func:`variant_for` picks one
from dtype, shapes and strides alone, before any launch:

- ``tc``: bf16, ``d % 16 == 0``, ``d <= 128``, ``Sq >= 2``, and q, k, v
  rows that ``cp.async`` can load (base pointers and (batch, head,
  sequence) strides 16-byte aligned): tensor-core prefill.
- ``decode``: ``Sq == 1``, either dtype, any ``d <= 256`` (up to
  :data:`DECODE_MAX_GROUP` q heads a kv head): split-kv, two launches
  (chunks, then their merge) over a scratch this wrapper allocates.
- ``simt``: everything else (f32, other head widths, unaligned views):
  the CUDA-core kernel.

Each wrapper call adds one to :func:`launch_count` and one to
``launch_count(variant)``. A build or launch error raises; no other
variant is tried.

:func:`flash_attention_lse` is the training forms' forward: self
attention (``Sq == Skv``) or cross attention (any ``Sq`` and ``Skv``,
non-causal, no window), the queries at ``q_offset`` 0 and no ``k_pos``,
``d`` a multiple of 16 up to 128; it launches ``tc`` where
:func:`variant_for` names it and ``simt`` otherwise (never ``decode``),
and the kernel also writes each row's log-sum-exp for the backward
kernels (``backward.py``).

Only the last dimension of q, k and v must be contiguous: a cache's
valid prefix ``cache[:, :, :n]`` and the ``transpose(1, 2)`` of a
projection go in as they are. The output is allocated as ``(B, Sq, Hq,
d)`` and returned as its ``(B, Hq, Sq, d)`` view, so the caller's
transpose back to ``(B, S, H, d)`` is contiguous. The launch reads
nothing back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import build
from .ref import attention_lse_plain, attention_plain, kv_span

MAX_D = 256
VARIANTS = ("tc", "decode", "simt")
TC_DIMS = tuple(range(16, 129, 16))
# decode: chunks of at most this many kv slots, halved (down to
# DECODE_MIN_CHUNK) until the grid covers the card's SMs twice; at most
# DECODE_MAX_SPLITS chunks (the merge keeps a weight of each in shared
# memory)
DECODE_CHUNK, DECODE_MIN_CHUNK, DECODE_MAX_SPLITS = 256, 32, 4096
SMS = 132  # H100 SXM
# decode stages the group's q rows in shared memory (at most 64 x 256 f32)
DECODE_MAX_GROUP = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ENTRY = {"simt": "flash_attn_launch", "tc": "flash_attn_tc_launch",
          "decode": "flash_attn_decode_launch"}
_STATS = dict.fromkeys(("launches", *VARIANTS), 0)
_FNS: dict = {}


def launch_count(variant: str | None = None) -> int:
    """Wrapper calls that launched a kernel since the last
    :func:`reset_launch_count` (of ``variant`` alone when named)."""
    return _STATS["launches" if variant is None else variant]


def reset_launch_count() -> None:
    for key in _STATS:
        _STATS[key] = 0


def _fn(variant: str):
    fn = _FNS.get(variant)
    if fn is None:
        fn = getattr(build.load("flash_attn"), _ENTRY[variant])
        fn.restype = ctypes.c_int
        ll, i = ctypes.c_longlong, ctypes.c_int
        args = ([ctypes.c_void_p] * 6 + [i] * 7 + [ll] * 12
                + [i, i, i, ctypes.c_float])
        if variant == "decode":
            args += [ctypes.c_void_p] + [i] * 5
        fn.argtypes = args + [ctypes.c_void_p]
        _FNS[variant] = fn
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


def check_train(q, k, v, causal, window) -> None:
    """Raise unless (q, k, v) is a training form of the call: ``Sq ==
    Skv`` (self attention), or ``Sq != Skv`` with ``causal`` false and no
    ``window`` (cross attention); ``d`` a multiple of 16 up to 128, f32
    or bf16, ``Hq % Hkv == 0``, one device."""
    _check(q, k, v, window, None)
    d = q.shape[3]
    cross = not causal and window is None
    if (q.shape[2] != k.shape[2] and not cross) or d % 16 or d > 128:
        raise ValueError(f"attention (training form): needs Sq == Skv (or "
                         f"Sq != Skv non-causal without a window) and d "
                         f"a multiple of 16 up to 128, got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")


def flash_attention_lse(q, k, v, *, causal: bool = True, window=None):
    """The training forms' forward: ``(out, lse)`` with ``out`` as
    :func:`flash_attention` gives it at ``q_offset = 0`` (no ``k_pos``)
    and ``lse`` (B, Hq, Sq) f32, each row's log-sum-exp of its scaled
    visible scores (:func:`ref.attention_lse_plain`). CUDA tensors take
    ``tc`` (bf16 where :func:`variant_for` names it) or ``simt``."""
    check_train(q, k, v, causal, window)
    return _forward_lse(q, k, v, causal, window)


def _forward_lse(q, k, v, causal, window):
    """:func:`flash_attention_lse` on inputs already checked. The queries
    sit at ``q_offset = 0`` (``None`` would put them at the kv suffix,
    a negative offset where Sq > Skv)."""
    dev = q.device
    if dev.type == "cpu":
        return attention_lse_plain(q, k, v, causal=causal, window=window,
                                   q_offset=0)
    if dev.type != "cuda":
        raise ValueError(f"attention: unsupported device {dev}")
    variant = "tc" if variant_for(q, k, v) == "tc" else "simt"
    B, Hq, Sq, _ = q.shape
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=dev)
    out = _run(variant, q, k, v, causal, window, 0, None, lse)
    return out, lse


def _inner(t):
    """``t`` itself when its last dimension is contiguous, else a copy."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _rows_aligned(t) -> bool:
    """Every (batch, head, sequence) row of ``t`` starts on 16 bytes, as
    a 16-byte ``cp.async`` or vector load needs (a view whose last
    dimension is not contiguous is copied first, and the copy is)."""
    if t.stride(-1) != 1:
        return True
    per = 16 // t.element_size()
    return (t.data_ptr() % 16 == 0 and t.shape[-1] % per == 0
            and all(s % per == 0 for s in t.stride()[:3]))


@functools.lru_cache(maxsize=256)
def decode_plan(B: int, Hkv: int, Skv: int, *, q_offset: int, causal: bool,
                window, has_kpos: bool):
    """``(lo, hi, chunk, splits)`` of the decode variant, from host ints
    alone: the kv span ``[lo, hi)`` (:func:`ref.kv_span`) cut into
    ``splits`` chunks of ``chunk`` slots. Chunks are 256 slots, halved
    down to 32 while the ``(splits, Hkv, B)`` grid would cover the card's
    132 SMs less than twice, and widened where there would be more than
    4096 of them."""
    lo, hi = kv_span(1, Skv, q_offset, causal, window, has_kpos)
    n = hi - lo
    chunk = DECODE_CHUNK
    while chunk > DECODE_MIN_CHUNK and B * Hkv * -(-n // chunk) < 2 * SMS:
        chunk //= 2
    chunk = max(chunk, -(-n // DECODE_MAX_SPLITS))
    return lo, hi, chunk, max(1, -(-n // chunk))


def variant_for(q, k, v) -> str:
    """The variant that takes these inputs: ``"decode"`` for one query
    row, ``"tc"`` for bf16 query blocks of a tensor-core head width
    with 16-byte aligned rows, ``"simt"`` for the rest. Decided from
    dtype, shapes, strides and base-pointer alignment alone (masks and
    kv positions do not change the choice)."""
    B, Hq, Sq, d = q.shape
    Hkv = k.shape[1]
    if Sq == 1 and Hq // Hkv <= DECODE_MAX_GROUP:
        return "decode"
    if (q.dtype == torch.bfloat16 and d in TC_DIMS and Sq >= 2
            and all(_rows_aligned(t) for t in (q, k, v))):
        return "tc"
    return "simt"


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    q_offset=None, k_pos=None):
    """q: (B, Hq, Sq, d), k/v: (B, Hkv, Skv, d) -> (B, Hq, Sq, d) in
    ``q.dtype``; the contract of :func:`ref.attention_plain` (``q_offset
    = None``: the queries are the kv sequence's suffix). f32 or bf16,
    d <= 256. CUDA tensors take the kernel :func:`variant_for` names."""
    dev = q.device
    if dev.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, k_pos=k_pos)
    if dev.type != "cuda":
        raise ValueError(f"attention: unsupported device {dev}")
    _check(q, k, v, window, k_pos)
    return _run(variant_for(q, k, v), q, k, v, causal, window,
                q_offset, k_pos, None)


def _launch(variant: str, q, k, v, *, causal: bool = True, window=None,
            q_offset=None, k_pos=None):
    """Launch the named variant on CUDA tensors (it must take them:
    ``simt`` takes all, ``tc`` and ``decode`` what :func:`variant_for`
    would give them). For tests and measurements; the models call
    :func:`flash_attention`."""
    if q.device.type != "cuda":
        raise ValueError(f"attention: {variant} runs on CUDA tensors, got "
                         f"{q.device}")
    _check(q, k, v, window, k_pos)
    if variant not in VARIANTS:
        raise ValueError(f"attention: unknown variant {variant!r}")
    if variant != "simt" and variant_for(q, k, v) != variant:
        raise ValueError(f"attention: the {variant} variant does not take "
                         f"q {tuple(q.shape)} {q.dtype} with strides "
                         f"{q.stride()}, k strides {k.stride()}")
    return _run(variant, q, k, v, causal, window, q_offset, k_pos, None)


def _run(variant, q, k, v, causal, window, q_offset, k_pos, lse):
    B, Hq, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if q_offset is None:
        q_offset = Skv - Sq
    q, k, v = _inner(q), _inner(k), _inner(v)
    dev = q.device
    out = torch.empty((B, Sq, Hq, d), dtype=q.dtype,
                      device=dev).transpose(1, 2)
    if k_pos is not None:
        k_pos = k_pos.contiguous()
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if k_pos is None else k_pos.data_ptr(),
            None if lse is None else lse.data_ptr(),
            _DTYPES[q.dtype], B, Hq, Hkv, Sq, Skv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], int(q_offset), int(causal),
            0 if window is None else int(window), 1.0 / (d ** 0.5)]
    if variant == "decode":
        lo, hi, chunk, splits = decode_plan(
            B, Hkv, Skv, q_offset=int(q_offset), causal=causal,
            window=window, has_kpos=k_pos is not None)
        part = torch.empty(B * Hq * splits * (d + 2), dtype=torch.float32,
                           device=dev)
        vec = _rows_aligned(k) and _rows_aligned(v)
        args += [part.data_ptr(), lo, hi, chunk, splits, int(vec)]
    err = _fn(variant)(*args, torch.cuda.current_stream(dev).cuda_stream)
    _STATS["launches"] += 1
    _STATS[variant] += 1
    build.check(err, f"flash_attention ({variant})")
    return out
