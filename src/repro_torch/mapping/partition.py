"""Tensor partitioning: the dense pass (one 2-D matrix a tensor).  The
reference's expert-axis partition comes with the MoE slice."""
from __future__ import annotations

import dataclasses

from repro_torch.mapping.base import Strategy, register


@register("partition", "dense")
@dataclasses.dataclass(frozen=True)
class DensePartition(Strategy):
    """Each 2-D tensor is one matrix; anything else is not split."""

    expert_axis = False

    def split(self, name: str, w):
        return [(name, w)] if w.ndim == 2 else None
