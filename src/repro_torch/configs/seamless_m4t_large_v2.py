"""seamless-m4t-large-v2 — encoder-decoder, multimodal (speech frontend
stubbed: input_specs() provides precomputed frame embeddings).
[arXiv:2308.11596; hf]

24L encoder + 24L decoder, d_model=1024 16H (kv=16) d_ff=8192
vocab=256206.
"""

from repro_torch.models.config import ModelCfg

CFG = ModelCfg(
    name="seamless-m4t-large-v2",
    kind="encdec", encoder_layers=24,
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256206, head_dim=64,
    frontend="audio", frontend_dim=1024,
)
