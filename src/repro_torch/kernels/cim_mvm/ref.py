"""Plain PyTorch versions of the fused CIM matmul.

``cim_effective_weights`` / ``cim_mvm_plain`` are the counterpart of the
reference's fused XLA path (``repro/kernels/cim_mvm/xla.py``) without
gain, column permutation or read noise: W' is expanded from the int16
codes with the kernel's formula and multiplied with ``torch.matmul``.
``cim_mvm_ref`` is the independent oracle through the materialised
Eq-17 path (``repro_torch.core.noise.noisy_magnitude``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.bitslice import codes_to_bits
from repro_torch.core.mdm import MdmPlan
from repro_torch.core.noise import noisy_magnitude
from repro_torch.core.tiling import CrossbarSpec


def cim_effective_weights(codes: torch.Tensor, pos: torch.Tensor,
                          scale: torch.Tensor, *, n_bits: int, wpt: int,
                          cols: int, eta: float,
                          reversed_df: bool) -> torch.Tensor:
    """W' (I, N) f32 from signed codes (I, N) int16, row positions
    (I, N // wpt) int32 and the scale:
    W' = sign * scale * [(1 + eta*p) * M0 + eta*M1]."""
    c = codes.to(torch.int32)
    mag = c.abs()
    sign = torch.where(c < 0, -1.0, 1.0)
    m0 = mag.to(torch.float32) * (2.0 ** -n_bits)
    N = codes.shape[1]
    slot = torch.arange(N, dtype=torch.int32, device=codes.device) % wpt
    m1 = torch.zeros_like(m0)
    for k in range(n_bits):
        bit = ((mag >> (n_bits - 1 - k)) & 1).to(torch.float32)
        col = slot * n_bits + k
        if reversed_df:
            col = (cols - 1) - col
        m1 = m1 + bit * (2.0 ** -(k + 1)) * col.to(torch.float32)
    p = pos.to(torch.float32).repeat_interleave(wpt, dim=1)
    return sign * scale * ((1.0 + eta * p) * m0 + eta * m1)


def cim_mvm_plain(x: torch.Tensor, dep) -> torch.Tensor:
    """y = x @ W' for x (M, in_dim) f32; returns (M, out_dim) f32."""
    i_pad = dep.codes.shape[0]
    x = F.pad(x.to(torch.float32), (0, i_pad - x.shape[-1]))
    w = cim_effective_weights(dep.codes, dep.pos, dep.scale,
                              n_bits=dep.n_bits, wpt=dep.wpt, cols=dep.cols,
                              eta=dep.eta, reversed_df=dep.reversed_df)
    return (x @ w)[:, :dep.out_dim]


def cim_mvm_ref(x: torch.Tensor, codes_signed: torch.Tensor, plan: MdmPlan,
                spec: CrossbarSpec, eta: float) -> torch.Tensor:
    """Oracle: y = x @ W' from signed codes (I, N) and an MDM plan."""
    mag = codes_signed.to(torch.int32).abs()
    sign = torch.where(codes_signed < 0, -1.0, 1.0)
    bits = codes_to_bits(mag, spec.n_bits)
    w_eff = sign * noisy_magnitude(bits, plan.scale, plan, spec, eta)
    return x.to(torch.float32) @ w_eff
