"""The LM substrate's models, counterpart of ``repro.models``:
``config`` (the architecture dataclasses), ``layers`` (norms, rotary,
attention through the flash-attention kernel, SwiGLU), ``moe`` (the
dense-dispatch MoE FFN), ``ssm`` (Mamba-1 through the selective-scan
kernel), ``rwkv`` (RWKV6 through the wkv6 kernel) and ``transformer``
(the decoder LM of any layer pattern, its caches, prefill and decode).
The encoder-decoder model and the frontend stubs are not ported yet."""
