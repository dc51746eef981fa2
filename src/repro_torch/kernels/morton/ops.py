"""The Morton-encode op, counterpart of ``repro/kernels/morton/ops.py``:
:func:`morton_encode` (the kernel for CUDA tensors, its plain version for
CPU tensors) and :func:`morton_encode_plain`."""

from __future__ import annotations

from .kernel import morton_encode
from .ref import morton_encode_plain

__all__ = ["morton_encode", "morton_encode_plain"]
