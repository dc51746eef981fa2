"""Plain PyTorch version of the Morton-encode kernel.

Counterpart of ``repro/kernels/morton/ref.py:morton_encode_ref``, and of
the expression the reference's core computes in
``repro/core/baselines.py:zd_build`` and ``repro/core/spac.py:_encode``:
``sfc.morton_encode(points.astype(uint32) >> shift, bits)`` with
``shift = max(0, coord_bits - bits)``. Coordinates are taken as the
reference's ``astype(uint32)`` takes them (negative int32 values wrap),
and codes come back as int64.
"""

from __future__ import annotations

from ...core import sfc


def morton_encode_plain(pts, *, bits: int, coord_bits: int):
    """(N, D) integer (or float) points -> (N,) int64 Morton codes of the
    coordinates shifted right by ``max(0, coord_bits - bits)``."""
    shift = max(0, coord_bits - bits)
    return sfc.morton_encode(sfc._as_code(pts) >> shift, bits)
