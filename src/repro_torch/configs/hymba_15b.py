"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attention + Mamba heads in the same
block (fused hybrid head), sliding-window attention on most layers.
[arXiv:2411.13676; hf]

vocab 32001 is padded to 32128 (a multiple of 128; padded logits
masked).  Its decode state is O(window) + O(1): the attention ring holds
sliding_window slots, the mamba state is (d_model, ssm_state).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    block_pattern=("hybrid",),
    sliding_window=1024,
    ssm_state=16,
    ssm_conv=4,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       d_ff=128, vocab_size=256, sliding_window=32,
                       ssm_state=4, attn_chunk=16)
