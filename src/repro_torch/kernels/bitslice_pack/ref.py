"""Plain PyTorch version of the bit-plane packing kernel."""
from __future__ import annotations

import torch

from repro_torch.core.bitslice import codes_to_bits


def bitslice_pack_plain(codes: torch.Tensor, n_bits: int,
                        reversed_df: bool = False) -> torch.Tensor:
    """(I, N) signed integer codes -> (I, N, n_bits) uint8 bit planes of
    ``|code|``, most significant first; mirrored along the last axis
    under reversed dataflow."""
    bits = codes_to_bits(codes.to(torch.int32).abs(), n_bits)
    return bits.flip(-1) if reversed_df else bits
