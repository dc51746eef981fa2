"""qwen3-moe-235b-a22b — 128-expert top-8 MoE on every layer (no dense
FFN). [hf:Qwen/Qwen3-30B-A3B scaled per assignment; hf]

94L d_model=4096 64H (GQA kv=4) per-expert d_ff=1536 vocab=151936.
head_dim=128 (explicit in the Qwen3 config, so Hq*hd != d_model).
"""

from repro_torch.models.config import ModelCfg, MoECfg

CFG = ModelCfg(
    name="qwen3-moe-235b-a22b",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab=151936, head_dim=128,
    moe=MoECfg(n_experts=128, top_k=8, d_ff=1536, every=1),
)
