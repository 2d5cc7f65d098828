"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]
At its bf16 width (93 GB) it does not fit one 80 GB card whole: the
card runs it at full width and a cut depth (``chip_smoke.py``).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    block_pattern=("attn",),
    sliding_window=4096,
    n_experts=8,
    n_experts_per_token=2,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       d_ff=128, vocab_size=256, n_experts=4,
                       n_experts_per_token=2, sliding_window=32, attn_chunk=16)
