"""The sieve: lambda-level buckets by midpoint compares and a stable
counting sort by bucket (``kernel.py``: the CUDA kernels of
``csrc/sieve.cu`` and their launch wrappers; ``ref.py``: the plain
PyTorch versions; ``ops.py``: chunking, offsets and the reference's
``sieve_histogram`` / ``sieve_partition``)."""

from . import kernel, ops, ref  # noqa: F401
