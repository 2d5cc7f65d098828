"""Plain PyTorch version of the flash-attention kernel.

The counterpart of the reference's chunked online-softmax attention
(``repro/models/attention.py::flash_attention``): the KV sequence is
scanned in chunks with a running max, denominator and weighted sum in
f32, and the same masking and guards as the kernel — causal over
absolute positions, optional window, EMPTY_POS padding, the max clamped
at NEG_INF/2 and the denominator floored at 1e-30 so that a fully
masked row returns 0.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30
EMPTY_POS = 2 ** 30


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_positions: torch.Tensor,
                          k_positions: torch.Tensor, window: int = 0,
                          chunk: int = 512) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k, v: (B, Skv, Hkv, Dh) -> (B, Sq, H, Dh).

    Positions are (Sq,) / (Skv,) shared across the batch, or (B, Sq) /
    (B, Skv) per sequence.
    """
    B, Sq, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = Dh ** -0.5
    chunk = min(chunk, Skv)
    n_chunks = -(-Skv // chunk)
    pad = n_chunks * chunk - Skv
    qp = q_positions if q_positions.ndim == 2 else q_positions[None]
    kp = k_positions if k_positions.ndim == 2 else k_positions[None]
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kp = F.pad(kp, (0, pad), value=EMPTY_POS)

    qf = q.to(torch.float32)
    m = torch.full((B, Sq, H), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Sq, H), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, H, Dh), dtype=torch.float32, device=q.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        k_c = k[:, sl].to(torch.float32)
        v_c = v[:, sl].to(torch.float32)
        if G > 1:
            k_c = k_c.repeat_interleave(G, dim=2)
            v_c = v_c.repeat_interleave(G, dim=2)
        s = torch.einsum("bqhd,bchd->bqhc", qf, k_c) * scale
        k_pos = kp[:, sl]
        valid = k_pos[:, None, :] <= qp[:, :, None]          # (b, Sq, c)
        if window:
            valid &= (qp[:, :, None] - k_pos[:, None, :]) < window
        s = torch.where(valid[:, :, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.clamp(m_new, min=NEG_INF / 2)
        p = torch.exp(s - m_safe[..., None])
        corr = torch.exp(torch.clamp(m - m_safe, max=0.0))
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bqhc,bchd->bqhd", p, v_c)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)
