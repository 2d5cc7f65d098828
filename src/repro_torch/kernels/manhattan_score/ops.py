"""Wrapper of the Manhattan score/NF reduction kernel (``kernel.cu``)."""
from __future__ import annotations

import torch

from repro_torch.device import check_on, resolve_device
from repro_torch.kernels import runtime
from repro_torch.kernels.manhattan_score.ref import manhattan_score_plain
from repro_torch.launch.roofline import PEAK_F32, Cost

# The forms of kernel.cu: one byte at a time, or 16-byte loads and SIMD
# byte arithmetic (packed column indices must fit a byte; a row's lanes
# must be an aligned power-of-two group of a warp).
BYTE_FORM, VECTOR_FORM = 0, 1
VECTOR_COLS = (16, 32, 64, 128, 256)


def score_form(cols: int, aligned: bool) -> int:
    """The kernel form for tiles of ``cols`` columns (any row count);
    ``aligned`` says whether the masks start on 16 bytes."""
    return VECTOR_FORM if aligned and cols in VECTOR_COLS else BYTE_FORM


def cost(T: int, R: int, C: int, placed: bool = False) -> Cost:
    """The work of one :func:`manhattan_score` over T tiles of R x C:
    the masks (and a placement) read, scores, counts and NF written,
    once; 3 operations a cell."""
    n_bytes = T * R * C + T * R * 4 * 2 + T * 4 + (T * R * 4 if placed
                                                      else 0)
    return Cost(3.0 * T * R * C, PEAK_F32, n_bytes)


def manhattan_score(masks: torch.Tensor, nf_unit: float = 1.0, *,
                    reverse: bool = False,
                    row_position: torch.Tensor | None = None,
                    device: str | torch.device = "cuda"):
    """Row scores, row counts and per-tile NF of 0/1 tile masks.

    masks: (..., R, C); ``row_position`` (..., R) int32 or None.
    Returns (scores (..., R), counts (..., R), nf (...)), all f32.
    """
    dev = resolve_device(device)
    check_on(dev, masks=masks, row_position=row_position)
    batch = masks.shape[:-2]
    R, C = masks.shape[-2:]
    flat = masks.reshape(-1, R, C)
    if flat.dtype != torch.uint8:
        flat = (flat != 0).to(torch.uint8)
    flat = flat.contiguous()
    rp = None
    if row_position is not None:
        rp = row_position.reshape(-1, R)
        if rp.dtype != torch.int32 or rp.shape[0] != flat.shape[0]:
            raise ValueError("row_position must be int32 of shape "
                             f"{tuple(batch) + (R,)}")
        rp = rp.contiguous()
    if dev.type == "cpu" or flat.shape[0] == 0:
        s, n, nf = manhattan_score_plain(flat, nf_unit, reverse, rp)
    else:
        T = flat.shape[0]
        s = torch.empty((T, R), dtype=torch.float32, device=dev)
        n = torch.empty((T, R), dtype=torch.float32, device=dev)
        nf = torch.empty((T,), dtype=torch.float32, device=dev)
        lib = runtime.library()
        rc = lib.manhattan_score_launch(
            flat.data_ptr(), None if rp is None else rp.data_ptr(),
            s.data_ptr(), n.data_ptr(), nf.data_ptr(), T, R, C,
            int(reverse), float(nf_unit),
            score_form(C, flat.data_ptr() % 16 == 0),
            runtime.stream_arg(s.device))
        runtime.count_launch("manhattan_score")
        runtime.check_status("manhattan_score", rc)
    return s.reshape(*batch, R), n.reshape(*batch, R), nf.reshape(batch)
