"""internvl2-26b — VLM backbone (InternLM2-20B side); the InternViT
frontend is a stub (input_specs() provides precomputed patch
embeddings, 256 positions of dim 3200 after pixel-shuffle).
[arXiv:2404.16821; hf]

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.
"""

from repro_torch.models.config import ModelCfg

CFG = ModelCfg(
    name="internvl2-26b",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=92553, head_dim=128,
    frontend="vision", frontend_seq=256, frontend_dim=3200,
)
