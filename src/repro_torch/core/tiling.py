"""Mapping weight matrices onto bit-sliced crossbar tiles.

Port of ``repro.core.tiling``.  A weight matrix W of shape
(in_dim, out_dim) deploys onto a grid of crossbar tiles of
``spec.rows`` rows x ``spec.cols`` columns; each weight occupies
``spec.n_bits`` adjacent columns (high-order bit first under
conventional dataflow), so one tile holds ``spec.cols // spec.n_bits``
output columns and ``spec.rows`` input rows.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F


class CrossbarSpec(NamedTuple):
    """Physical crossbar tile + device parameters (paper §III-B / §V)."""

    rows: int = 64
    cols: int = 64
    n_bits: int = 8
    r: float = 2.5          # parasitic wire resistance per segment [ohm]
    r_on: float = 300e3     # active-cell resistance [ohm]
    r_off: float = 3e6      # inactive-cell resistance [ohm]
    v_read: float = 0.2     # row read voltage [V]

    @property
    def weights_per_tile(self) -> int:
        if self.cols % self.n_bits:
            raise ValueError(f"cols={self.cols} not divisible by n_bits={self.n_bits}")
        return self.cols // self.n_bits

    @property
    def nf_unit(self) -> float:
        """r / R_on — the NF slope of the Manhattan Hypothesis."""
        return self.r / self.r_on

    def grid(self, in_dim: int, out_dim: int) -> tuple[int, int]:
        """(row_tiles, col_tiles) needed for an (in_dim, out_dim) matrix."""
        return (math.ceil(in_dim / self.rows),
                math.ceil(out_dim / self.weights_per_tile))


def pad_to_tiles(bits: torch.Tensor, spec: CrossbarSpec) -> torch.Tensor:
    """Zero-pad a (I, N, K) bit tensor so I, N fill whole tiles."""
    I, N, _ = bits.shape
    ti, tn = spec.grid(I, N)
    pad_i = ti * spec.rows - I
    pad_n = tn * spec.weights_per_tile - N
    if pad_i or pad_n:
        bits = F.pad(bits, (0, 0, 0, pad_n, 0, pad_i))
    return bits


def tile_masks(bits: torch.Tensor, spec: CrossbarSpec) -> torch.Tensor:
    """(I, N, K) uint8 bit planes -> (Ti, Tn, rows, cols) tile masks in
    conventional dataflow layout (high-order bit at the smallest column
    index inside each weight's K-column group)."""
    K = bits.shape[-1]
    if K != spec.n_bits:
        raise ValueError(f"bit planes {K} != spec.n_bits {spec.n_bits}")
    bits = pad_to_tiles(bits, spec)
    I, N = bits.shape[0], bits.shape[1]
    ti, tn = I // spec.rows, N // spec.weights_per_tile
    m = bits.reshape(ti, spec.rows, tn, spec.weights_per_tile, K)
    m = m.permute(0, 2, 1, 3, 4)
    return m.reshape(ti, tn, spec.rows, spec.cols)


def untile_masks(masks: torch.Tensor, in_dim: int, out_dim: int,
                 spec: CrossbarSpec) -> torch.Tensor:
    """Inverse of :func:`tile_masks`; crops padding. Returns (I, N, K)."""
    ti, tn = masks.shape[0], masks.shape[1]
    K = spec.n_bits
    m = masks.reshape(ti, tn, spec.rows, spec.weights_per_tile, K)
    m = m.permute(0, 2, 1, 3, 4)
    m = m.reshape(ti * spec.rows, tn * spec.weights_per_tile, K)
    return m[:in_dim, :out_dim]


def reverse_dataflow(masks: torch.Tensor) -> torch.Tensor:
    """Mirror tile columns: the low-order (dense) bits move next to the
    input rail (paper MDM step 1).  Pure relabelling of the physical
    column order."""
    return masks.flip(-1)
