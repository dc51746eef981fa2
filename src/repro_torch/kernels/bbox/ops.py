"""The row-bbox op, counterpart of ``repro/kernels/bbox/ops.py``:
:func:`row_bbox` (the kernel for CUDA tensors, its plain version for CPU
tensors) and :func:`row_bbox_plain`."""

from __future__ import annotations

from .kernel import row_bbox
from .ref import row_bbox_plain

__all__ = ["row_bbox", "row_bbox_plain"]
