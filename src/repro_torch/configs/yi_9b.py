"""yi-9b — llama-architecture dense GQA. [arXiv:2403.04652; hf]

48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""

from repro_torch.models.config import ModelCfg

CFG = ModelCfg(
    name="yi-9b",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11008, vocab=64000, head_dim=128,
)
