"""Row-order strategies: which logical row lands on which physical row.

Port of ``repro.mapping.rows``.  A pass maps the per-row keys of a
(T, rows) tile population — active counts and Manhattan scores in the
placed column layout, as the ``manhattan_score`` kernel computes them —
and, for the fault-consuming passes, the physical cell states, to a
(T, rows) permutation (``perm[t, p]`` = logical row hosted at physical
position ``p``), or None for the identity.  Every fault-consuming pass
reduces exactly to :class:`MdmRows` without a fault map.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.manhattan import row_order_from_keys, steer_rows
from repro_torch.mapping.base import Strategy, register


def _steer(counts, scores, n_cols, stuck, spec, **kw):
    """The MDM density rank, steered off faulty rows when ``stuck`` is
    given (the reference's ``fault_aware_row_order`` over the tile
    population; its rank is the one the keys give)."""
    rank = row_order_from_keys(counts, scores, n_cols)
    if stuck is None:
        return rank
    return steer_rows(rank, stuck, spec.nf_unit, **kw)


@register("rows", "identity")
@dataclasses.dataclass(frozen=True)
class IdentityRows(Strategy):
    """Keep the original row order (the paper's baseline/reverse)."""

    def order(self, counts, scores, n_cols, stuck=None, col_sig=None,
              spec=None) -> None:
        return None


@register("rows", "mdm")
@dataclasses.dataclass(frozen=True)
class MdmRows(Strategy):
    """Paper step 3: densest rows to the positions nearest the rails."""

    def order(self, counts, scores, n_cols, stuck=None, col_sig=None,
              spec=None) -> torch.Tensor:
        return row_order_from_keys(counts, scores, n_cols)


@register("rows", "fault_aware")
@dataclasses.dataclass(frozen=True)
class FaultAwareRows(Strategy):
    """MDM plus stuck-cell steering (one unit a stuck cell)."""

    uses_faults = True

    def order(self, counts, scores, n_cols, stuck=None, col_sig=None,
              spec=None) -> torch.Tensor:
        return _steer(counts, scores, n_cols, stuck, spec)


@register("rows", "spare_line")
@dataclasses.dataclass(frozen=True)
class SpareLineRows(Strategy):
    """Fault-aware MDM with an ``open_penalty`` surcharge per OPEN cell:
    a severed wordline outranks every healthy position, so it hosts the
    sparsest (ideally a spare all-zero) logical row."""

    open_penalty: float = 4.0

    uses_faults = True

    def order(self, counts, scores, n_cols, stuck=None, col_sig=None,
              spec=None) -> torch.Tensor:
        return _steer(counts, scores, n_cols, stuck, spec,
                      open_penalty=self.open_penalty)


@register("rows", "significance_weighted")
@dataclasses.dataclass(frozen=True)
class SignificanceWeightedRows(Strategy):
    """Fault steering with each stuck column weighted by the bit plane it
    hosts, 2^-(k+1) (``col_sig``)."""

    uses_faults = True
    uses_col_significance = True

    def order(self, counts, scores, n_cols, stuck=None, col_sig=None,
              spec=None) -> torch.Tensor:
        return _steer(counts, scores, n_cols, stuck, spec,
                      col_weights=col_sig)
