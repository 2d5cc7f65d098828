"""Position-dependent PR distortion (paper Eq 17), materialised.

Port of ``repro.core.noise.noisy_magnitude``, the oracle that
``kernels/cim_mvm/ref.py::cim_mvm_ref`` builds on:

    |w'| = scale * [(1 + eta * p) * M0 + eta * M1]
    M0   = sum_k b_k 2^-(k+1)            (clean magnitude)
    M1   = sum_k b_k 2^-(k+1) * c_k      (column-distance moment)

with p the physical row after the plan and c_k the physical column of
bit plane k (mirrored under reversed dataflow).
"""
from __future__ import annotations

import torch

from repro_torch.core.mdm import MdmPlan
from repro_torch.core.tiling import CrossbarSpec

# Paper's SPICE-calibrated value for r=2.5ohm, R_on=300kohm (§V-C).
PAPER_ETA = 2e-3


def noisy_magnitude(bits: torch.Tensor, scale: torch.Tensor, plan: MdmPlan,
                    spec: CrossbarSpec, eta: float) -> torch.Tensor:
    """Effective |W'| (I, N) after PR distortion under ``plan``."""
    I, N, K = bits.shape
    dev = bits.device
    rows, wpt = spec.rows, spec.weights_per_tile
    b = bits.to(torch.float32)
    bw = 2.0 ** -(1.0 + torch.arange(K, dtype=torch.float32, device=dev))

    slot = torch.arange(N, device=dev) % wpt
    col = slot[:, None] * K + torch.arange(K, device=dev)[None, :]
    if plan.reversed_dataflow:
        col = (spec.cols - 1) - col

    i = torch.arange(I, device=dev)
    tn = torch.arange(N, device=dev) // wpt
    pos_itn = plan.row_position[i // rows, :, i % rows]        # (I, Tn)
    p = pos_itn[:, tn].to(torch.float32)                       # (I, N)

    m0 = torch.einsum("ink,k->in", b, bw)
    m1 = torch.einsum("ink,nk->in", b, bw * col.to(torch.float32))
    return scale * ((1.0 + eta * p) * m0 + eta * m1)
