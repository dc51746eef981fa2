"""Flash attention: blocked online-softmax attention with causal and
sliding-window masks, grouped-query heads and explicit kv positions
(``kernel.py``: the CUDA kernel ``csrc/flash_attn.cu`` and its launch
wrapper; ``backward.py``: the backward kernels ``csrc/flash_attn_bwd.cu``
and the training form's autograd function; ``ref.py``: the plain PyTorch
versions; ``ops.py``: the ops, re-exported)."""

from . import backward, kernel, ops, ref  # noqa: F401
