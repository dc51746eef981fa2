"""Flash attention: blocked online-softmax attention with causal and
sliding-window masks, grouped-query heads and explicit kv positions
(``kernel.py``: the CUDA kernel ``csrc/flash_attn.cu`` and its launch
wrapper; ``ref.py``: the plain PyTorch version; ``ops.py``: both,
re-exported)."""

from . import kernel, ops, ref  # noqa: F401
