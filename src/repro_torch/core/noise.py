"""Position-dependent PR distortion (paper Eq 17), materialised.

Port of ``repro.core.noise`` (``noisy_magnitude``, ``noisy_weights``,
``tree_noisy_weights``; ``calibrate_eta`` needs the circuit solver and
comes with it), the oracle that ``kernels/cim_mvm/ref.py::cim_mvm_ref``
builds on:

    |w'| = scale * [(1 + eta * p) * M0 + eta * M1]
    M0   = sum_k b_k 2^-(k+1)            (clean magnitude)
    M1   = sum_k b_k 2^-(k+1) * c_k      (column-distance moment)

with p the physical row after the plan and c_k the physical column of
bit plane k (mirrored under reversed dataflow, then moved through the
plan's column permutation when it has one).
"""
from __future__ import annotations

import torch

from repro_torch.core.bitslice import bitslice
from repro_torch.core.mdm import MdmPlan, plan_from_bits
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
    if plan.col_position is None:
        m1 = torch.einsum("ink,nk->in", b, bw * col.to(torch.float32))
    else:
        colp = plan.col_position[(i // rows)[:, None, None],
                                 tn[None, :, None], col[None, :, :]]
        m1 = torch.einsum("ink,ink->in", b, bw * colp.to(torch.float32))
    return scale * ((1.0 + eta * p) * m0 + eta * m1)


def noisy_weights(w: torch.Tensor, spec: CrossbarSpec, mode="mdm",
                  eta: float = PAPER_ETA, plan: MdmPlan | None = None):
    """Eq 17 end to end: bit-slice, plan (unless ``plan`` is given),
    distort.  Returns (W' (I, N) f32, plan); with eta = 0, the plain
    bit-sliced quantisation of W."""
    sliced = bitslice(w, spec.n_bits)
    if plan is None:
        plan = plan_from_bits(sliced.bits, sliced.scale, spec, mode)
    mag = noisy_magnitude(sliced.bits, sliced.scale, plan, spec, eta)
    return mag * sliced.sign.to(torch.float32), plan


def tree_noisy_weights(params, spec: CrossbarSpec, mode="mdm",
                       eta: float = PAPER_ETA, min_size: int = 1024):
    """Eq 17 on every 2-D weight of a nested dict of tensors with at
    least ``min_size`` elements, and on every matrix of a stacked
    (layers, in, out) one; anything else (biases, norms) is kept."""
    def visit(x):
        if isinstance(x, dict):
            return {k: visit(v) for k, v in x.items()}
        if not isinstance(x, torch.Tensor):
            return x
        if x.ndim == 2 and x.numel() >= min_size:
            return noisy_weights(x, spec, mode, eta)[0].to(x.dtype)
        if x.ndim == 3 and x.shape[1] * x.shape[2] >= min_size:
            return torch.stack([noisy_weights(m, spec, mode, eta)[0]
                                for m in x]).to(x.dtype)
        return x

    return visit(params)
