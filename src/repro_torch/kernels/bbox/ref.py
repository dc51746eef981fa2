"""Plain PyTorch version of the row-bbox kernel.

Counterpart of ``repro/core/leafstore.py:row_bbox_from_slots`` -- the
function the reference's core path computes -- and not of
``repro/kernels/bbox/ref.py``, which casts to float32 with a 3.4e38
sentinel as its TPU kernel does. The result keeps the points' dtype, and
a row with no valid slot gets ``(+max, -max)`` of that dtype. NaN
coordinates are outside the contract (and so is the sign of a zero where
``0.0`` and ``-0.0`` tie).
"""

from __future__ import annotations

import torch


def dtype_max(dtype) -> float | int:
    """Largest finite value of ``dtype`` (the empty-row sentinel)."""
    if dtype.is_floating_point:
        return torch.finfo(dtype).max
    return torch.iinfo(dtype).max


def row_bbox_plain(pts, valid):
    """(lo, hi) over the valid slots of each row. pts: (R, C, D); valid:
    (R, C) bool -> two (R, D) tensors in ``pts.dtype``."""
    big = dtype_max(pts.dtype)
    m = valid[..., None]
    return (torch.where(m, pts, big).amin(dim=1),
            torch.where(m, pts, -big).amax(dim=1))
