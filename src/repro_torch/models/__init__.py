"""Models of the port: the ``"attn"`` decoder (SwiGLU or GELU MLP, routed
MoE), hybrid, mamba and xLSTM blocks, and the stub frontends."""
