"""Wrapper of the bit-plane packing kernel (``kernel.cu``)."""
from __future__ import annotations

import torch

from repro_torch.device import check_on, resolve_device
from repro_torch.kernels import runtime
from repro_torch.kernels.bitslice_pack.ref import bitslice_pack_plain
from repro_torch.launch.roofline import PEAK_F32, Cost

_CODE_BYTES = {torch.int16: 2, torch.int32: 4}


def cost(n: int, n_bits: int, code_bytes: int = 4) -> Cost:
    """The work of one :func:`bitslice_pack` of n codes: the codes read
    and the n x n_bits image written, once; a shift, an and and an or a
    plane, counted at the f32 rate."""
    return Cost(3.0 * n_bits * n, PEAK_F32, n * code_bytes + n * n_bits)


def bitslice_pack(codes: torch.Tensor, n_bits: int,
                  reversed_df: bool = False, *,
                  device: str | torch.device = "cuda") -> torch.Tensor:
    """(I, N) int16 or int32 signed codes -> (I, N, n_bits) uint8 bit
    planes of ``|code|``, most significant first, mirrored along the
    last axis under reversed dataflow: the crossbar programming image."""
    dev = resolve_device(device)
    check_on(dev, codes=codes)
    if codes.dtype not in _CODE_BYTES:
        raise TypeError(f"bitslice_pack takes int16 or int32 codes, got "
                        f"{codes.dtype}")
    if not 1 <= n_bits <= 31:
        raise ValueError(f"n_bits must lie in [1, 31], got {n_bits}")
    if dev.type == "cpu":
        return bitslice_pack_plain(codes, n_bits, reversed_df)
    codes = codes.contiguous()
    out = torch.empty(codes.shape + (n_bits,), dtype=torch.uint8,
                      device=dev)
    if codes.numel() == 0:
        return out
    lib = runtime.library()
    rc = lib.bitslice_pack_launch(
        codes.data_ptr(), _CODE_BYTES[codes.dtype], out.data_ptr(),
        codes.numel(), n_bits, int(reversed_df),
        runtime.stream_arg(out.device))
    runtime.count_launch("bitslice_pack")
    runtime.check_status("bitslice_pack", rc)
    return out
