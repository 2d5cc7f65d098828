"""Whole-model MDM planning, one matrix at a time.

Port of ``repro.deploy.planner`` without the plan cache and the mesh
sharding.  Each matrix is quantised, bit-sliced and tiled on its own
device, and its tile population is planned in one pass
(:func:`repro_torch.core.mdm.plan_tile_population`, whose reductions
run in the ``manhattan_score`` kernel on the card).  Planning proceeds
in chunks of one matrix: phi3-mini's 7.07M tiles at once would be 29 GB
of uint8 masks, one 8192 x 3072 matrix is 200 MB.

``quantize_codes_host`` is the numpy mirror of the code rounding; with
the scale fixed, numpy, XLA and PyTorch agree on it bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bitslice import codes_to_bits, quantize_magnitude
from repro_torch.core.mdm import plan_from_bits
from repro_torch.core.tiling import CrossbarSpec
from repro_torch.mapping import MappingPipeline


def quantize_codes_host(w: np.ndarray, scale: np.float32,
                        n_bits: int) -> np.ndarray:
    """Host mirror of ``quantize_magnitude``'s code rounding (uint32);
    ``scale`` from ``magnitude_scale_host``."""
    levels = (1 << n_bits) - 1
    mag = np.abs(np.asarray(w, np.float32))
    return np.clip(np.round(mag / scale * np.float32(1 << n_bits)),
                   np.float32(0), np.float32(levels)).astype(np.uint32)


def plan_matrix(w: torch.Tensor, spec: CrossbarSpec,
                mode: str | MappingPipeline = "mdm"):
    """Quantise and plan one (I, N) matrix on its device.

    Returns (plan, codes, sign, scale); the codes and signs feed
    packaging without a second quantisation pass.
    """
    if w.ndim != 2:
        raise ValueError(f"expected a 2-D matrix, got {tuple(w.shape)}")
    codes, sign, scale = quantize_magnitude(w, spec.n_bits)
    plan = plan_from_bits(codes_to_bits(codes, spec.n_bits), scale, spec,
                          mode)
    return plan, codes, sign, scale

