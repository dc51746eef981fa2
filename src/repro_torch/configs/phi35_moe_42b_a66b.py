"""phi3.5-moe-42b-a6.6b — 16-expert top-2 MoE on every layer.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]

32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064.
"""

from repro_torch.models.config import ModelCfg, MoECfg

CFG = ModelCfg(
    name="phi3.5-moe-42b-a6.6b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=6400, vocab=32064, head_dim=128,
    moe=MoECfg(n_experts=16, top_k=2, d_ff=6400, every=1),
)
