"""Tensor partitioning: how a weight tensor splits into the 2-D matrices
that each get their own tile grid, plan and cache entry.

Port of ``repro.mapping.partition``.  The partition pass enters the
pipeline's fingerprint but not the per-matrix plan-cache keys: each
matrix is addressed by its own bytes.
"""
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


@register("partition", "expert")
@dataclasses.dataclass(frozen=True)
class ExpertPartition(Strategy):
    """MoE banks: a stacked (E, I, N) expert bank splits along its
    leading axis into E matrices ``{name}/e{e}`` (views), each on its
    own tile grid; a 2-D matrix passes through; anything else is not
    split."""

    expert_axis = True

    def split(self, name: str, w):
        if w.ndim == 2:
            return [(name, w)]
        if w.ndim == 3:
            return [(f"{name}/e{e}", w[e]) for e in range(w.shape[0])]
        return None
