"""qwen1.5-0.5b — dense with QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]

24L d_model=1024 16H (kv=16, i.e. MHA) d_ff=2816 vocab=151936.
"""

from repro_torch.models.config import ModelCfg

CFG = ModelCfg(
    name="qwen1.5-0.5b",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=2816, vocab=151936, head_dim=64,
    qkv_bias=True,
)
