"""qwen2.5-32b [dense]: 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064, QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    block_pattern=("attn",),
    qkv_bias=True,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=40, n_heads=5, n_kv_heads=1,
                       d_ff=128, vocab_size=256, attn_chunk=16)
