"""Theorem 1: bit-level structured sparsity of DNN weights.

Port of ``repro.core.theory``.  For a nonnegative random variable W with
a continuous, strictly decreasing density f on [0, inf), the
fractional-bit activation probability p_k = P(b_k = 1) satisfies
|p_k - 1/2| <= f(0) / 2^(1+k) and p_k < 1/2 for every k (b_k the 2^-k
coefficient bit, as in ``core/bitslice.py``).

This module evaluates p_k by quadrature over the bit indicator's
periods and by sampling, and gives the bound and the bit-plane
densities of a weight tensor.  Everything is f32, as the reference's
with x64 off.  The quadrature grid (2^18 points) is the one piece of
work here, so :func:`p_k_quadrature` takes an explicit ``device``
(default ``"cuda"``); the other functions run where their tensors lie.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.core.bitslice import bitslice, column_density, mean_f32
from repro_torch.device import resolve_device

Density = Callable[[torch.Tensor], torch.Tensor]


def bit_indicator(w: torch.Tensor, k: int) -> torch.Tensor:
    """b_k(w): the 2^-k fractional bit of w >= 0 (k >= 1), int32."""
    return torch.remainder(torch.floor(w * (2.0 ** k)), 2).to(torch.int32)


def p_k_quadrature(f: Density, k: int, w_max: float = 32.0,
                   n_points: int = 2 ** 18,
                   device: str | torch.device = "cuda") -> torch.Tensor:
    """P(b_k = 1): the integral of f over the half-periods where b_k = 1,
    normalised over [0, w_max].  Midpoint rule on a grid aligned to the
    bit period 2^-k, so the indicator is constant within each cell."""
    dev = resolve_device(device)
    cell = 2.0 ** (-k) / 2.0
    sub = max(1, int(n_points * cell / w_max))
    n_cells = int(round(w_max / cell))
    edges = torch.arange(n_cells, device=dev) * cell
    offs = (torch.arange(sub, device=dev) + 0.5) * (cell / sub)
    pts = edges[:, None] + offs[None, :]
    mass = f(pts) * (cell / sub)
    return torch.sum(mass * bit_indicator(pts, k)) / torch.sum(mass)


def p_k_empirical(samples: torch.Tensor, k: int) -> torch.Tensor:
    return mean_f32(bit_indicator(samples.abs(), k).to(torch.float32))


def theorem1_bound(f0: float, k: int) -> float:
    """|p_k - 1/2| <= f(0) / 2^(1+k) for the standard 2^-k coefficient bit.

    On conventions: the paper's proof defines the indicator with period
    L = 2^-k (0 on the first half-period, 1 on the second), which is the
    2^-(k+1) coefficient of the standard binary expansion, so paper-b_k
    is standard-b_(k+1) and the paper's f(0)/2^(2+k) for its indicator is
    f(0)/2^(1+k') for the standard bit k' = k + 1.  Bits here are indexed
    by the standard coefficient (as in ``core/bitslice.py``), hence
    2^(1+k).  The telescoping argument is unchanged: Delta_k <= (period
    / 2) f(0).
    """
    return f0 / (2.0 ** (1 + k))


# Bell-shaped magnitude densities (|w| of common weight distributions).

def half_normal(sigma: float) -> Density:
    c = math.sqrt(2.0 / math.pi) / sigma
    return lambda w: c * torch.exp(-(w ** 2) / (2 * sigma ** 2))


def exponential(lam: float) -> Density:
    return lambda w: lam * torch.exp(-lam * w)


def half_laplace(b: float) -> Density:
    return lambda w: (1.0 / b) * torch.exp(-w / b)


def empirical_bit_densities(w: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Density of each bit plane of ``w`` after bit-slicing, (n_bits,)
    f32, plane 0 the 2^-1 bit.  Theorem 1 predicts a profile below 1/2
    that rises with k for bell-shaped weights: the structured sparsity
    MDM exploits."""
    return column_density(bitslice(w, n_bits).bits)
