"""command-r-35b — dense GQA, no biases.
[hf:CohereForAI/c4ai-command-r-v01; unverified]

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000. (The HF model
uses a parallel attn+FFN block; we keep the sequential residual layout
shared by the zoo — FLOP-identical, noted in DESIGN.md.)
"""

from repro_torch.models.config import ModelCfg

CFG = ModelCfg(
    name="command-r-35b",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22528, vocab=256000, head_dim=128,
)
