"""The Manhattan Hypothesis: analytical parasitic-resistance NF model.

Port of ``repro.core.manhattan`` (paper §III-B, Eq 16):

    NF ~= (r / R_on) * sum_{j,k} delta_{j,k} * (j + k)

with (j, k) a cell's row / column distance from the I/O rails.  All
functions take tile masks of shape (..., J, K).  Every sum here is an
integer far below 2^24, so the f32 results are exact whatever the
summation order.
"""
from __future__ import annotations

import torch


def distance_grid(rows: int, cols: int, dtype=torch.float32,
                  device=None) -> torch.Tensor:
    """Manhattan distance d(j,k) = j + k of every cell from the I/O corner."""
    j = torch.arange(rows, dtype=dtype, device=device)[:, None]
    k = torch.arange(cols, dtype=dtype, device=device)[None, :]
    return j + k


def aggregate_distance(active: torch.Tensor) -> torch.Tensor:
    """sum_{j,k} delta_{j,k} (j+k) per tile, shape (...)."""
    J, K = active.shape[-2], active.shape[-1]
    d = distance_grid(J, K, device=active.device)
    return (active.to(torch.float32) * d).sum((-2, -1))


def nonideality_factor(active: torch.Tensor, r: float,
                       r_on: float) -> torch.Tensor:
    """Eq 16: NF of a tile under the Manhattan Hypothesis."""
    return (r / r_on) * aggregate_distance(active)


def row_scores(active: torch.Tensor) -> torch.Tensor:
    """score_j = sum_k delta_{j,k} * (1 + k), shape (..., J)."""
    K = active.shape[-1]
    col = 1.0 + torch.arange(K, dtype=torch.float32, device=active.device)
    return (active.to(torch.float32) * col).sum(-1)


def row_counts(active: torch.Tensor) -> torch.Tensor:
    """Number of active cells per row, shape (..., J)."""
    return active.to(torch.float32).sum(-1)


def row_order_from_keys(counts: torch.Tensor, scores: torch.Tensor,
                        n_cols: int) -> torch.Tensor:
    """Row permutations (..., J) int64 from per-row counts and scores.

    Sort by count descending, then score descending, then index
    ascending — the reference's order exactly.  While
    ``n * (s_max + 1) + s`` fits int32 (tiles up to ~1290 columns) the
    two keys pack into one and a single stable argsort sorts them; wide
    tiles take two stable argsorts, secondary key first (the
    reference's lexsort).
    """
    K = n_cols
    n = counts.to(torch.int64)
    s = scores.to(torch.int64)
    s_max = K * (K + 1) // 2
    if (K + 1) * (s_max + 1) - 1 < 2 ** 31:
        key = (n * (s_max + 1) + s).to(torch.int32)
        return torch.argsort(-key, dim=-1, stable=True)
    by_score = torch.argsort(-s, dim=-1, stable=True)
    by_count = torch.argsort(-torch.gather(n, -1, by_score), dim=-1,
                             stable=True)
    return torch.gather(by_score, -1, by_count)


def optimal_row_order(active: torch.Tensor) -> torch.Tensor:
    """Row permutation minimising the Manhattan-model NF (paper step 3):
    densest rows nearest the rail, ties by Manhattan score, then index.
    Returns ``perm`` with ``active[..., perm, :]`` the remapped tile."""
    a = (active > 0)
    return row_order_from_keys(row_counts(a), row_scores(a),
                               active.shape[-1])


def inverse_permutation(perm: torch.Tensor) -> torch.Tensor:
    """position[..., perm[..., p]] = p (int32), the inverse of a batch of
    permutations along the last axis."""
    pos = torch.empty_like(perm, dtype=torch.int32)
    ar = torch.arange(perm.shape[-1], dtype=torch.int32, device=perm.device)
    return pos.scatter_(-1, perm.to(torch.int64), ar.expand_as(pos))
