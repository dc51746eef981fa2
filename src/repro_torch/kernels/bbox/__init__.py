"""Masked per-row bounding boxes of leaf rows (``kernel.py``: the CUDA
kernel ``csrc/row_bbox.cu`` and its launch wrapper; ``ref.py``: the
plain PyTorch version; ``ops.py``: both, re-exported)."""

from . import kernel, ops, ref  # noqa: F401
