"""Model configuration (architecture zoo).

The port's own copy of ``repro/models/config.py``: the same frozen
dataclasses, fields and defaults, less the reference's XLA knobs
(attention chunk sizes and causal pruning, shard_map dispatch,
``scan_layers``): the port's attention is one kernel launch and its
layers run as a Python loop, so it has nothing for them to set.
``moe_group`` stays: MoE capacity is counted per group of tokens, so it
decides which tokens drop. The training knobs stay: ``loss_chunk``
(cross-entropy in sequence chunks) and ``remat`` (``none``, ``dots`` or
``full``, mapped onto ``torch.utils.checkpoint`` per layer group).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff: int            # per-expert hidden
    every: int = 1       # MoE on layers where (i % every == every - 1)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMCfg:             # Mamba-1
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0      # 0 => d_model // 16


@dataclasses.dataclass(frozen=True)
class RWKVCfg:            # RWKV6 "Finch"
    head_dim: int = 64
    decay_lora: int = 64
    mix_lora: int = 32


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 => d_model // n_heads
    kind: str = "decoder"        # decoder | encdec
    encoder_layers: int = 0
    # per-layer pattern, cycled over layers: 'a'=attention, 'm'=mamba,
    # 'r'=rwkv. "a" = plain transformer; jamba = "mmmammmm".
    pattern: str = "a"
    rope_theta: float = 1e6
    qkv_bias: bool = False
    window: Optional[int] = None         # sliding-window attention
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    rwkv: Optional[RWKVCfg] = None
    frontend: Optional[str] = None       # None | 'audio' | 'vision'
    frontend_seq: int = 0                # stub embedding positions
    frontend_dim: int = 1024             # stub embedding feature dim
    tie_embeddings: bool = True
    norm_eps: float = 1e-5
    act_dtype: str = "bfloat16"
    moe_group: int = 4096                # tokens a MoE capacity group
    loss_chunk: int = 1024               # CE computed in seq chunks
    remat: str = "dots"                  # none | dots | full

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def group_pattern(self) -> str:
        return self.pattern

    @property
    def n_groups(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, \
            f"{self.n_layers} layers not divisible by pattern {self.pattern}"
        return self.n_layers // len(self.pattern)

    def layer_type(self, i: int) -> str:
        return self.pattern[i % len(self.pattern)]

    def is_moe_layer(self, i: int) -> bool:
        return self.moe is not None and (i % self.moe.every
                                         == self.moe.every - 1)

    def with_(self, **kw) -> "ModelCfg":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    mode: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}
