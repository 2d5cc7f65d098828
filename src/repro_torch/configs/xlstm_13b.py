"""xlstm-1.3b [ssm]: 48L d_model=2048 4H d_ff=0 vocab=50304 —
alternating mLSTM + sLSTM blocks (d_ff=0: the blocks carry their own
up/down projections, no separate FFN).  [arXiv:2405.04517; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm", "slstm"),
    mlp_type="none",
    ssm_expand=2,
)
