"""h2o-danube-1.8b — dense llama+mistral mix with sliding-window
attention. [arXiv:2401.16818; hf]

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, SWA window 4096
=> sub-quadratic attention => runs long_500k (ring KV cache of 4096).
"""

from repro_torch.models.config import ModelCfg

CFG = ModelCfg(
    name="h2o-danube-1.8b",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=6912, vocab=32000, head_dim=80,
    window=4096,
)
