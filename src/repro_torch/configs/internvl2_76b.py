"""internvl2-76b [vlm]: InternViT frontend (stub) + InternLM2-76B backbone.

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256
[arXiv:2404.16821; unverified]
The ViT frontend is a stub: prompts are precomputed patch embeddings of
width d_model (``repro_torch.models.frontend.synthetic_embeddings``);
decode steps feed tokens.  At its bf16 width (80 layers, ~137 GB of
params) it does not fit one 80 GB card whole.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    block_pattern=("attn",),
    frontend="vision",
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       d_ff=128, vocab_size=256, attn_chunk=16)
