"""Morton encode: quantize (``>> shift``) and bit-interleave integer
points into Z-curve codes (``kernel.py``: the CUDA kernel
``csrc/morton.cu`` and its launch wrapper; ``ref.py``: the plain PyTorch
version; ``ops.py``: both, re-exported)."""

from . import kernel, ops, ref  # noqa: F401
