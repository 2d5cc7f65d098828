"""musicgen-medium [audio]: 48L d_model=1536 24H (GQA kv=24) d_ff=6144
vocab=2048, a GELU MLP: a decoder-only transformer over EnCodec tokens.
[arXiv:2306.05284; hf]
The EnCodec frontend is a stub: prompts are precomputed frame embeddings
(``repro_torch.models.frontend.synthetic_embeddings``); decode steps
feed codec tokens (vocab 2048).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    block_pattern=("attn",),
    mlp_type="gelu",
    frontend="audio",
)

SMOKE = CONFIG.replace(n_layers=2, d_model=48, n_heads=4, n_kv_heads=4,
                       d_ff=96, vocab_size=128, attn_chunk=16)
