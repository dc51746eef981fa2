"""The attention op, counterpart of ``repro/kernels/flash_attn/ops.py``:
:func:`flash_attention` (the kernel for CUDA tensors, its plain version
for CPU tensors), its differentiable training form
:func:`flash_attention_train`, and :func:`attention_plain`."""

from __future__ import annotations

from .backward import flash_attention_train
from .kernel import flash_attention
from .ref import attention_plain

__all__ = ["attention_plain", "flash_attention", "flash_attention_train"]
