"""Row-order strategies: which logical row lands on which physical row.

Port of the two row passes the legacy pipelines use
(``repro.mapping.rows``): ``identity`` and ``mdm``.  A pass maps the
per-row keys of a (T, rows) tile population — active counts and
Manhattan scores in the physical column layout, as the
``manhattan_score`` kernel computes them — to a (T, rows) permutation
(``perm[t, p]`` = logical row hosted at physical position ``p``), or
None for the identity.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.manhattan import row_order_from_keys


@dataclasses.dataclass(frozen=True)
class IdentityRows:
    """Keep the original row order (the paper's baseline/reverse)."""

    def order(self, counts: torch.Tensor, scores: torch.Tensor,
              n_cols: int) -> None:
        return None


@dataclasses.dataclass(frozen=True)
class MdmRows:
    """Paper step 3: densest rows to the positions nearest the rails."""

    def order(self, counts: torch.Tensor, scores: torch.Tensor,
              n_cols: int) -> torch.Tensor:
        return row_order_from_keys(counts, scores, n_cols)
