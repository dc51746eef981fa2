"""The LM substrate's models, counterpart of ``repro.models``:
``config`` (the architecture dataclasses), ``layers`` (norms, rotary,
attention through the flash-attention kernel, SwiGLU), ``moe`` (the
dense-dispatch MoE FFN), ``ssm`` (Mamba-1 through the selective-scan
kernel), ``rwkv`` (RWKV6 through the wkv6 kernel), ``transformer``
(the decoder LM of any layer pattern, with the frontend stubs'
``prefix_embed``, its caches, prefill and decode) and ``encdec`` (the
encoder-decoder: encoder, cross-attention decoder, its caches, prefill
and decode)."""

from . import config, encdec, layers, moe, rwkv, ssm, transformer  # noqa: F401
from .encdec import EncDecLM  # noqa: F401
from .transformer import DecoderLM  # noqa: F401
