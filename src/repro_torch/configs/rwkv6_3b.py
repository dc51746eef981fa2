"""rwkv6-3b "Finch" — attention-free, data-dependent decay linear
attention. [arXiv:2404.05892; hf]

32L d_model=2560 d_ff=8960 vocab=65536. Time-mix state is
(H, 64, 64)/layer => O(1) decode; runs long_500k natively. n_heads /
n_kv_heads are placeholders (no attention layers exist).
"""

from repro_torch.models.config import ModelCfg, RWKVCfg

CFG = ModelCfg(
    name="rwkv6-3b",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=8960, vocab=65536,
    pattern="r",
    rwkv=RWKVCfg(head_dim=64, decay_lora=64, mix_lora=32),
)
