"""The LM substrate's models, counterpart of ``repro.models``:
``config`` (the architecture dataclasses), ``layers`` (norms, rotary,
attention through the flash-attention kernel, SwiGLU) and
``transformer`` (the dense decoder LM, its caches, prefill and decode).
The MoE, Mamba, RWKV and encoder-decoder mixers are not ported yet."""
