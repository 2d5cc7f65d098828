"""Attention of the port: rotary embedding and causal flash attention
over absolute positions.

Port of ``repro.models.attention``.  Masking is position-based: queries
and keys carry absolute token positions, so one code path serves prefill
and ring-buffer decode (empty cache slots hold ``EMPTY_POS`` and mask
themselves out).  :func:`flash_attention` runs the hand-written kernel
on CUDA tensors and the plain chunked online-softmax version
(``kernels/flash_attention/ref.py``, the same masking and guards as the
reference) on CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    EMPTY_POS,
    NEG_INF,
    flash_attention_plain,
)

__all__ = ["EMPTY_POS", "NEG_INF", "flash_attention",
           "flash_attention_plain", "rope"]


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (B, S, H, Dh); positions (S,) shared across
    the batch, or (B, S) per sequence."""
    Dh = x.shape[-1]
    half = Dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    if positions.ndim == 1:
        ang = positions[None, :, None, None].to(torch.float32) * freqs
    else:
        ang = positions[:, :, None, None].to(torch.float32) * freqs
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
