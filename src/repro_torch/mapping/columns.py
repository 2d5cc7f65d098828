"""Column-order strategies: which bit column lands on which bitline.

Port of ``repro.mapping.columns``.  Every crossbar column is sensed
independently and shift-added digitally, so any per-tile bitline
permutation preserves the matmul — only the parasitic exposure (and,
under faults, which columns a dead bitline silences) changes.  The
X-CHANGR sort ranks columns by the ``manhattan_score`` kernel's keys of
the transposed tiles.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.manhattan import fault_aware_col_order, row_order_from_keys
from repro_torch.kernels.manhattan_score.ops import manhattan_score
from repro_torch.mapping.base import Strategy, register


def _densest_first(placed: torch.Tensor) -> torch.Tensor:
    """``optimal_col_order`` of a (T, rows, cols) population: the column
    counts and scores from one ``manhattan_score`` pass over the
    transposed tiles."""
    cols_major = placed.transpose(-1, -2).contiguous()
    scores, counts, _ = manhattan_score(cols_major, 0.0,
                                        device=placed.device)
    return row_order_from_keys(counts, scores, placed.shape[-2])


@register("cols", "identity")
@dataclasses.dataclass(frozen=True)
class IdentityCols(Strategy):
    """Keep the (possibly dataflow-reversed) column order unchanged."""

    def order_tiles(self, placed, stuck, col_sig, spec) -> None:
        return None


@register("cols", "xchangr")
@dataclasses.dataclass(frozen=True)
class XChangrCols(Strategy):
    """X-CHANGR-style bitline sort: densest columns nearest the rail
    (the column-wise dual of the MDM row sort)."""

    def order_tiles(self, placed, stuck, col_sig, spec) -> torch.Tensor:
        return _densest_first(placed)


@register("cols", "spare_line")
@dataclasses.dataclass(frozen=True)
class SpareLineCols(Strategy):
    """Bitline sort steering logical columns off faulty and open
    bitlines, ranked by significance x total column current (active
    cells plus the ``r_on / r_off`` off-current a severed bitline also
    silences); an OPEN bitline, surcharged by ``open_penalty``, hosts
    the cheapest column.  :class:`XChangrCols` without a fault map."""

    open_penalty: float = 4.0

    uses_faults = True
    uses_col_significance = True

    def order_tiles(self, placed, stuck, col_sig, spec) -> torch.Tensor:
        if stuck is None:
            return _densest_first(placed)
        if col_sig is None:
            return fault_aware_col_order(placed, stuck, spec.nf_unit,
                                         open_penalty=self.open_penalty)
        return fault_aware_col_order(placed, stuck, spec.nf_unit,
                                     col_weights=col_sig,
                                     open_penalty=self.open_penalty,
                                     off_current=spec.r_on / spec.r_off)
