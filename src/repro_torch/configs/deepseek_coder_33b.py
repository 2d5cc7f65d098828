"""deepseek-coder-33b [dense]: 62L d_model=7168 56H (GQA kv=8) d_ff=19200
vocab=32256, llama-arch.  [arXiv:2401.14196; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=19200,
    vocab_size=32256,
    block_pattern=("attn",),
)

SMOKE = CONFIG.replace(n_layers=2, d_model=56, n_heads=7, n_kv_heads=1,
                       d_ff=128, vocab_size=256, attn_chunk=16)
