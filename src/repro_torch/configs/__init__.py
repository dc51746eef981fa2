"""Architecture registry: the 10 assigned archs + smoke reductions.

The port's copy of ``repro/configs/__init__.py`` and its data modules.
``ARCHS[arch_id]`` is the exact published config; ``smoke(arch_id)`` is
a reduced same-family config for CPU tests (small width, few experts,
tiny vocab). The port serves every arch: the decoder archs and
internvl2's vision frontend stub through ``repro_torch.models.transformer``
(``prefix_embed``), seamless-m4t's encoder-decoder through
``repro_torch.models.encdec``; it trains the decoder archs without a
frontend. ``configs.psi`` holds the paper's own workload grid.

``cells(arch_id)`` lists the applicable input-shape cells:
long_500k needs sub-quadratic attention (runs for ssm/hybrid/SWA archs,
skipped for pure full-attention archs).
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import SHAPES, ModelCfg, ShapeCfg  # noqa: F401

from . import (command_r_35b, h2o_danube_18b, internvl2_26b,
               jamba_1_5_large_398b, phi35_moe_42b_a66b, qwen3_moe_235b_a22b,
               qwen15_05b, rwkv6_3b, seamless_m4t_large_v2, yi_9b)

ARCHS: dict[str, ModelCfg] = {
    m.CFG.name: m.CFG
    for m in (jamba_1_5_large_398b, qwen3_moe_235b_a22b, phi35_moe_42b_a66b,
              rwkv6_3b, h2o_danube_18b, command_r_35b, yi_9b, qwen15_05b,
              seamless_m4t_large_v2, internvl2_26b)
}

# archs with sub-quadratic attention (SSM / hybrid / sliding-window)
LONG_OK = {"jamba-1.5-large-398b", "rwkv6-3b", "h2o-danube-1.8b"}


def cells(arch_id: str) -> list[str]:
    """Applicable shape cells for this arch (assignment skip rules)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if arch_id in LONG_OK:
        names.append("long_500k")
    return names


def smoke(arch_id: str) -> ModelCfg:
    """Reduced same-family config: 1-2 groups, tiny width/vocab/experts."""
    cfg = ARCHS[arch_id]
    kw = dict(
        n_layers=len(cfg.pattern) * min(2, cfg.n_groups),
        d_model=128, n_heads=4, n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads
        else 4, head_dim=32, d_ff=256, vocab=512, moe_group=256,
        loss_chunk=128,
    )
    if cfg.n_kv_heads == cfg.n_heads:
        kw["n_heads"] = kw["n_kv_heads"] = 4
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, n_experts=4, top_k=2,
                                        d_ff=256)
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=4)
    if cfg.rwkv is not None:
        kw["rwkv"] = dataclasses.replace(cfg.rwkv, head_dim=32,
                                         decay_lora=16, mix_lora=8)
        kw["n_heads"] = kw["n_kv_heads"] = 4
    if cfg.window is not None:
        kw["window"] = 32
    if cfg.kind == "encdec":
        kw["encoder_layers"] = 2
    if cfg.frontend is not None:
        kw["frontend_seq"] = 8
        kw["frontend_dim"] = 32
    return cfg.with_(**kw)
