"""Mamba-1's selective scan and output contraction (``kernel.py``: the
CUDA kernel ``csrc/selective_scan.cu`` and its launch wrapper;
``ref.py``: the plain PyTorch version)."""

from . import kernel, ref  # noqa: F401
