"""Gradient compression for the cross-pod all-reduce: int8 with error
feedback.

Port of ``repro.distributed.compression``.  Per-tensor symmetric int8
quantisation, summed over the ranks in int32, dequantised with the mean
of the ranks' scales; the local quantisation residual is fed back into
the next step's gradient.  The reference runs inside ``shard_map`` over
the "pod" mesh axis; here the pods are processes of a
``torch.distributed`` group and the sums are ``all_reduce`` calls.
"""
from __future__ import annotations

import torch


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8 quantisation. Returns (q, scale)."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax, min=1e-30) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_decompress(x: torch.Tensor):
    """Round trip (for error-feedback accounting). Returns (xq, residual)."""
    q, s = quantize_int8(x)
    xq = dequantize_int8(q, s)
    return xq, x - xq


def psum_compressed(grads: list, error: list, group=None):
    """Error-feedback int8 sum over the ranks of ``group`` (None: the
    default group).

    grads / error: lists of f32 per-rank gradients and residuals, in one
    order on every rank.  Returns (reduced, new_error): each reduced
    leaf is the int32 sum of the ranks' int8 payloads times the mean of
    their scales (the per-rank scales of statistically homogeneous
    data-parallel gradients are close), each new residual the local
    payload's: (g + e) - dequantize(quantize(g + e)).
    """
    import torch.distributed as dist

    n = dist.get_world_size(group)
    red, new_e = [], []
    for g, e in zip(grads, error):
        g = g + e                               # inject residual
        q, s = quantize_int8(g)
        qs = q.to(torch.int32)
        dist.all_reduce(qs, group=group)
        ssum = s.clone()
        dist.all_reduce(ssum, group=group)
        red.append(qs.to(torch.float32) * (ssum / n))
        new_e.append(g - dequantize_int8(q, s))
    return red, new_e
