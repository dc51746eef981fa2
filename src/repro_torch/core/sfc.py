"""Space-filling curves: Morton (Z) and Hilbert encodings, vectorized.

Counterpart of ``repro/core/sfc.py``. The reference carries codes as
``uint32``; torch on the CPU has no shifts, comparisons or
``searchsorted`` for ``uint32``, so the port carries them in ``int64``
(:data:`CODE_DTYPE`). A 32-bit code is non-negative there, so the order
is the reference's. Codes wider than 32 bits (``bits * D > 32``, the
reference's ``uint64`` case) are not ported.

Hilbert encoding follows Skilling, "Programming the Hilbert curve"
(2004); the loops run over bit levels, never over points.
"""

from __future__ import annotations

import torch

CODE_DTYPE = torch.int64
CODE_BITS = 32

__all__ = ["CODE_DTYPE", "morton_encode", "hilbert_encode",
           "hilbert_decode", "interleave_bits", "max_bits"]


def _check_width(dim: int, bits: int) -> None:
    if dim * bits > CODE_BITS:
        raise ValueError(f"code of {dim * bits} bits: the port carries "
                         f"codes of at most {CODE_BITS} bits")


def max_bits(dim: int) -> int:
    """Bits per dimension of the widest code the port carries."""
    return CODE_BITS // dim


def _part1by1(x):
    """Spread bits of x so there is one zero bit between each (2D)."""
    x = x & 0xFFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def _part1by2(x):
    """Spread bits of x so there are two zero bits between each (3D)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _as_code(coords):
    """Integer coordinates as non-negative int64 words (the reference's
    ``astype(uint32)``: negative int32 values wrap)."""
    return coords.to(CODE_DTYPE) & 0xFFFFFFFF


def interleave_bits(coords, bits: int):
    """Interleave integer coordinates (..., D) into one int64 word.

    Bit ``j`` of ``coords[..., i]`` lands at ``j * D + (D - 1 - i)``, so
    ``coords[..., 0]`` gives the most significant bit of each group."""
    dim = coords.shape[-1]
    _check_width(dim, bits)
    c = _as_code(coords)
    if dim == 2:
        return (_part1by1(c[..., 0]) << 1) | _part1by1(c[..., 1])
    if dim == 3:
        return ((_part1by2(c[..., 0]) << 2) | (_part1by2(c[..., 1]) << 1)
                | _part1by2(c[..., 2]))
    out = torch.zeros(coords.shape[:-1], dtype=CODE_DTYPE,
                      device=coords.device)
    for b in range(bits):
        for i in range(dim):
            out = out | (((c[..., i] >> b) & 1) << (b * dim + (dim - 1 - i)))
    return out


def morton_encode(coords, bits: int | None = None):
    """Morton (Z-curve) code of non-negative integer coordinates (..., D)."""
    dim = coords.shape[-1]
    return interleave_bits(coords, max_bits(dim) if bits is None else bits)


def _axes_to_transpose(coords, bits: int):
    """Skilling's AxestoTranspose, vectorized over points."""
    dim = coords.shape[-1]
    X = [_as_code(coords[..., i]) for i in range(dim)]
    M = 1 << (bits - 1)
    Q = M
    while Q > 1:   # inverse undo
        P = Q - 1
        for i in range(dim):
            has = (X[i] & Q) != 0
            t = torch.where(has, 0, (X[0] ^ X[i]) & P)
            X[0] = torch.where(has, X[0] ^ P, X[0]) ^ t
            if i != 0:
                X[i] = X[i] ^ t
        Q >>= 1
    for i in range(1, dim):   # Gray encode
        X[i] = X[i] ^ X[i - 1]
    t = torch.zeros_like(X[0])
    Q = M
    while Q > 1:
        t = torch.where((X[dim - 1] & Q) != 0, t ^ (Q - 1), t)
        Q >>= 1
    return torch.stack([x ^ t for x in X], dim=-1)


def _transpose_to_axes(X, bits: int):
    """Skilling's TransposetoAxes (inverse of _axes_to_transpose)."""
    dim = X.shape[-1]
    X = [X[..., i].to(CODE_DTYPE) for i in range(dim)]
    N = 2 << (bits - 1)
    t = X[dim - 1] >> 1   # Gray decode by H ^ (H/2)
    for i in range(dim - 1, 0, -1):
        X[i] = X[i] ^ X[i - 1]
    X[0] = X[0] ^ t
    Q = 2
    while Q != N:   # undo excess work
        P = Q - 1
        for i in range(dim - 1, -1, -1):
            has = (X[i] & Q) != 0
            t = torch.where(has, 0, (X[0] ^ X[i]) & P)
            X[0] = torch.where(has, X[0] ^ P, X[0]) ^ t
            if i != 0:
                X[i] = X[i] ^ t
        Q <<= 1
    return torch.stack(X, dim=-1)


def hilbert_encode(coords, bits: int | None = None):
    """Hilbert code of non-negative integer coordinates (..., D)."""
    dim = coords.shape[-1]
    bits = max_bits(dim) if bits is None else bits
    _check_width(dim, bits)
    return interleave_bits(_axes_to_transpose(coords, bits), bits)


def _deinterleave_bits(code, dim: int, bits: int):
    code = code.to(CODE_DTYPE)
    outs = []
    for i in range(dim):
        x = torch.zeros_like(code)
        for b in range(bits):
            x = x | (((code >> (b * dim + (dim - 1 - i))) & 1) << b)
        outs.append(x)
    return torch.stack(outs, dim=-1)


def hilbert_decode(code, dim: int, bits: int):
    """Inverse of :func:`hilbert_encode` (used by tests)."""
    return _transpose_to_axes(_deinterleave_bits(code, dim, bits), bits)
