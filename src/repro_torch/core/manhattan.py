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


def placement_cost(active: torch.Tensor) -> torch.Tensor:
    """NF-proportional cost of the current row placement: sum_j j n_j
    (the permutable term) plus the placement-independent sum_jk
    delta_jk k, i.e. :func:`aggregate_distance`."""
    return aggregate_distance(active)


def antidiagonal_mirror(active: torch.Tensor) -> torch.Tensor:
    """(j, k) -> (k, j) of a square tile: every anti-diagonal j + k maps
    onto itself, so the mirrored tile has the same Eq 16 NF (Fig 2)."""
    return active.transpose(-1, -2)


def inverse_permutation(perm: torch.Tensor) -> torch.Tensor:
    """position[..., perm[..., p]] = p (int32), the inverse of a batch of
    permutations along the last axis."""
    pos = torch.empty_like(perm, dtype=torch.int32)
    ar = torch.arange(perm.shape[-1], dtype=torch.int32, device=perm.device)
    return pos.scatter_(-1, perm.to(torch.int64), ar.expand_as(pos))


def optimal_col_order(active: torch.Tensor) -> torch.Tensor:
    """Column permutation minimising the Manhattan-model NF: the
    transpose of :func:`optimal_row_order` (densest columns nearest the
    rail, ties by column score, then index).  Returns ``perm`` with
    ``active[..., :, perm]`` the remapped tile."""
    return optimal_row_order(active.transpose(-1, -2))


def _sort_desc(primary: torch.Tensor,
               secondary: torch.Tensor) -> torch.Tensor:
    """Permutations sorting the last axis by ``primary`` descending, then
    ``secondary`` descending, then index (the reference's
    ``lexsort((-secondary, -primary))``)."""
    by_sec = torch.argsort(-secondary, dim=-1, stable=True)
    by_pri = torch.argsort(-torch.gather(primary, -1, by_sec), dim=-1,
                           stable=True)
    return torch.gather(by_sec, -1, by_pri)


def fault_aware_row_order(active: torch.Tensor, stuck: torch.Tensor,
                          nf_unit: float,
                          col_weights: torch.Tensor | None = None,
                          open_penalty: float = 0.0,
                          line_weights: torch.Tensor | None = None,
                          off_current: float = 0.0) -> torch.Tensor:
    """Row permutations (..., J) minimising Manhattan NF plus expected
    fault loss, batched over leading dims (reference
    ``repro.core.manhattan.fault_aware_row_order``).

    ``active`` (..., J, K) holds the placed masks and ``stuck`` the
    physical cell states.  Importance is the MDM density ranking, or
    with ``line_weights`` the line's significance times its total
    current ``n + (K - n) * off_current`` (ties by Manhattan score, then
    index); :func:`steer_rows` then assigns positions.  Every value is
    computed in f32 with the reference's operations in its order."""
    K = active.shape[-1]
    f32 = torch.float32
    a = (active > 0).to(f32)
    if line_weights is None:
        rank = row_order_from_keys(a.sum(-1), row_scores(a), K)
    else:
        n = a.sum(-1)
        s = (a * (1.0 + torch.arange(K, dtype=f32,
                                     device=active.device))).sum(-1)
        cur = n + (K - n) * torch.tensor(off_current, dtype=f32,
                                         device=active.device)
        rank = _sort_desc(line_weights.to(f32) * cur, s)
    return steer_rows(rank, stuck, nf_unit, col_weights, open_penalty)


def steer_rows(row_rank: torch.Tensor, stuck: torch.Tensor, nf_unit: float,
               col_weights: torch.Tensor | None = None,
               open_penalty: float = 0.0) -> torch.Tensor:
    """Assign the rows ranked by ``row_rank`` (..., J) (most important
    first) to the physical positions of the cell states ``stuck``
    (..., J, K: 1 stuck-OFF, 2 stuck-ON, 3 OPEN) by ascending
    ``phi_p = nf_unit * p + pen_p``: ``pen_p`` is the position's
    stuck-OFF and OPEN minus stuck-ON cells over K (weighted by
    ``col_weights`` where given), plus ``open_penalty`` per OPEN cell
    over K.  Hosting line j at p costs importance_j * phi_p, so by the
    rearrangement inequality this is the optimum.  With no stuck cells
    phi rises with p and the rank is kept."""
    J, K = stuck.shape[-2], stuck.shape[-1]
    dev = stuck.device
    f32 = torch.float32
    off_like = ((stuck == 1) | (stuck == 3)).to(f32)
    on = (stuck == 2).to(f32)
    if col_weights is None:
        pen = (off_like.sum(-1) - on.sum(-1)) / K
    else:
        w = col_weights.to(f32)[..., None, :]
        pen = (((w * off_like).sum(-1) - (w * on).sum(-1))
               / torch.clamp(w.sum(-1), min=1e-30))
    if open_penalty:
        pen = pen + (torch.tensor(open_penalty, dtype=f32, device=dev)
                     * (stuck == 3).to(f32).sum(-1) / K)
    phi = (torch.tensor(nf_unit, dtype=f32, device=dev)
           * torch.arange(J, dtype=f32, device=dev) + pen)
    pos_rank = torch.argsort(phi, dim=-1, stable=True)
    return torch.empty_like(row_rank).scatter_(-1, pos_rank, row_rank)


def fault_aware_col_order(active: torch.Tensor, stuck: torch.Tensor,
                          nf_unit: float,
                          col_weights: torch.Tensor | None = None,
                          open_penalty: float = 0.0,
                          off_current: float = 0.0) -> torch.Tensor:
    """Column permutations steering logical columns off faulty bitlines:
    :func:`fault_aware_row_order` of the transposed tiles, with the
    columns' significance ``col_weights`` (where given) weighting each
    column's total current."""
    return fault_aware_row_order(active.transpose(-1, -2),
                                 stuck.transpose(-1, -2), nf_unit,
                                 open_penalty=open_penalty,
                                 line_weights=col_weights,
                                 off_current=off_current)
