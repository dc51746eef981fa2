"""RWKV6's wkv recurrence (``kernel.py``: the CUDA kernel
``csrc/wkv6.cu`` and its launch wrapper; ``ref.py``: the plain PyTorch
version)."""

from . import kernel, ref  # noqa: F401
