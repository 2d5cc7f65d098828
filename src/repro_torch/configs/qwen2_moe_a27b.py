"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60 routed experts top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
Routed-expert hidden width is 1408; the shared-expert path uses
4 * 1408 = 5632 (the HF shared_expert_intermediate_size).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5632,            # shared-expert path width (4 fused shared experts)
    vocab_size=151936,
    block_pattern=("attn",),
    qkv_bias=True,
    n_experts=60,
    n_experts_per_token=4,
    n_shared_experts=4,
    moe_d_ff=1408,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                       d_ff=96, vocab_size=256, n_experts=8,
                       n_experts_per_token=4, n_shared_experts=2,
                       moe_d_ff=32, attn_chunk=16)
