"""internlm2-20b [dense]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544.  [arXiv:2403.17297; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92544,
    block_pattern=("attn",),
)

SMOKE = CONFIG.replace(n_layers=2, d_model=48, n_heads=4, n_kv_heads=2,
                       d_ff=128, vocab_size=256, attn_chunk=16)
