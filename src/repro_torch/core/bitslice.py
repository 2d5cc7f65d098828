"""Bit-sliced weight decomposition for memristive crossbars.

Port of ``repro.core.bitslice`` (paper §II-A): each weight is mapped
across ``K`` fractional-bit columns,

    w = sign(w) * scale * sum_{k=1..K} b_k(w) 2^{-k}

with bits stored along the last axis, position 0 = the 2^-1 plane.  The
rounding chain is bit-identical to the reference: divide by the scale,
multiply by 2^K, round half to even, clip.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SlicedWeights(NamedTuple):
    """bits (w.shape + (K,)) uint8, sign int8 (+1/-1), scale f32 ()."""

    bits: torch.Tensor
    sign: torch.Tensor
    scale: torch.Tensor

    @property
    def n_bits(self) -> int:
        return self.bits.shape[-1]


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def magnitude_scale(w: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Quantisation scale so |w|/scale lands in [0, 1), as a 0-dim f32
    tensor on ``w``'s device.

    Same op chain as the reference (max is exact; every constant is
    rounded to f32 before its f32 op), so the scale is bit-identical
    to ``repro.core.bitslice.magnitude_scale`` and to
    :func:`magnitude_scale_host`.
    """
    levels = (1 << n_bits) - 1
    s = w.detach().to(torch.float32).abs().amax()
    s = s * _f32((1 << n_bits) / levels, s)
    s = s * _f32(1.0 + 1e-6, s)
    return s + _f32(1e-30, s)


def magnitude_scale_host(w, n_bits: int) -> np.float32:
    """Host (numpy) mirror of :func:`magnitude_scale`, bit-identical."""
    levels = (1 << n_bits) - 1
    s = np.float32(np.max(np.abs(np.asarray(w, np.float32))))
    s = np.float32(s * np.float32((1 << n_bits) / levels))
    s = np.float32(s * np.float32(1.0 + 1e-6))
    return np.float32(s + np.float32(1e-30))


def quantize_magnitude(w: torch.Tensor, n_bits: int,
                       scale: torch.Tensor | None = None):
    """Returns (codes int32 in [0, 2^K - 1], sign int8, scale f32 ())
    such that |w| ~= scale * codes * 2^-K."""
    w = w.to(torch.float32)
    if scale is None:
        scale = magnitude_scale(w, n_bits)
    levels = (1 << n_bits) - 1
    codes = torch.round(w.abs() / scale * float(1 << n_bits))
    codes = codes.clamp(0, levels).to(torch.int32)
    sign = torch.where(w < 0, -1, 1).to(torch.int8)
    return codes, sign, scale


def codes_to_bits(codes: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Integer codes -> bit planes, high-order first (uint8)."""
    shifts = torch.arange(n_bits - 1, -1, -1, dtype=torch.int32,
                          device=codes.device)
    return ((codes.to(torch.int32)[..., None] >> shifts) & 1).to(torch.uint8)


def bitslice(w: torch.Tensor, n_bits: int,
             scale: torch.Tensor | None = None) -> SlicedWeights:
    codes, sign, scale = quantize_magnitude(w, n_bits, scale)
    return SlicedWeights(codes_to_bits(codes, n_bits), sign, scale)


def bits_to_codes(bits: torch.Tensor) -> torch.Tensor:
    n_bits = bits.shape[-1]
    weights = 1 << torch.arange(n_bits - 1, -1, -1, dtype=torch.int32,
                                device=bits.device)
    return (bits.to(torch.int32) * weights).sum(-1, dtype=torch.int32)


def unbitslice(sliced: SlicedWeights) -> torch.Tensor:
    """The quantised weight tensor back from its bit-sliced form."""
    codes = bits_to_codes(sliced.bits)
    mag = codes.to(torch.float32) * (sliced.scale / (1 << sliced.n_bits))
    return mag * sliced.sign.to(torch.float32)


def quantization_error_bound(scale: torch.Tensor, n_bits: int
                             ) -> torch.Tensor:
    """Max absolute rounding error of the bit-sliced representation."""
    return scale * 0.5 * 2.0 ** (-n_bits)


def column_density(bits: torch.Tensor) -> torch.Tensor:
    """Fraction of active cells a bit plane, (K,) f32: the p_k estimate
    of Theorem 1 (``core/theory.py``).  The mean is the sum times 1/n
    rounded to f32, as XLA computes ``jnp.mean``."""
    return mean_f32(bits.reshape(-1, bits.shape[-1]).to(torch.float32), 0)


def mean_f32(x: torch.Tensor, dim=None) -> torch.Tensor:
    """``jnp.mean`` of f32 ``x`` bit for bit where the sum is exact: the
    sum times the f32 reciprocal of the count (``torch.mean`` divides,
    one ulp apart at times)."""
    n = x.numel() if dim is None else x.shape[dim]
    s = x.sum() if dim is None else x.sum(dim)
    return s * (1.0 / n)
