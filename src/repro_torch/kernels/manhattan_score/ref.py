"""Plain PyTorch version of the Manhattan score/NF reduction kernel."""
from __future__ import annotations

import torch


def manhattan_score_plain(masks: torch.Tensor, nf_unit: float,
                          reverse: bool = False,
                          row_position: torch.Tensor | None = None):
    """masks (T, R, C) -> (scores (T, R), counts (T, R), nf (T,)) f32;
    any nonzero mask entry counts as 1, as in the kernel.

    ``reverse`` scores the tiles in their mirrored column layout;
    ``row_position`` (T, R) int32 places logical row j at physical row
    ``row_position[t, j]`` for the NF.  Every sum is an exact integer in
    f32, as in the kernel and in the reference.
    """
    T, R, C = masks.shape
    m = (masks != 0).to(torch.float32)
    col = torch.arange(C, dtype=torch.float32, device=masks.device)
    if reverse:
        col = (C - 1) - col
    scores = (m * (1.0 + col)).sum(-1)
    counts = m.sum(-1)
    if row_position is None:
        rowp = torch.arange(R, dtype=torch.float32, device=masks.device)
    else:
        rowp = row_position.to(torch.float32)
    dist = (counts * rowp).sum(-1) + (m * col).sum((-2, -1))
    unit = torch.tensor(nf_unit, dtype=torch.float32, device=masks.device)
    return scores, counts, unit * dist
