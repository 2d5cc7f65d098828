"""Dense decoder of the port (``"attn"`` blocks, SwiGLU MLP)."""
