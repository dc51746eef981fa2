"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7 interleave, MoE 16e
top-2 on every other layer. [arXiv:2403.19887; hf]

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536. Pattern period 8
with the attention layer at position 3 (Jamba block layout); MoE every 2.
Mamba state is O(1)/token => runs the long_500k cell.
"""

from repro_torch.models.config import ModelCfg, MoECfg, SSMCfg

CFG = ModelCfg(
    name="jamba-1.5-large-398b",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab=65536, head_dim=128,
    pattern="mmmammmm",
    moe=MoECfg(n_experts=16, top_k=2, d_ff=24576, every=2),
    ssm=SSMCfg(d_state=16, d_conv=4, expand=2),
)
