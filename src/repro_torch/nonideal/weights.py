"""Eq-17 effective weights under device nonidealities (the exact
evaluator the deployment gain approximates).

Port of ``repro.nonideal.weights``: :func:`repro_torch.core.noise
.noisy_magnitude` generalised from binary bits to analog cell values
(:func:`repro_torch.nonideal.models.cell_values`),

    |w'| = scale * sum_k c_k 2^-(k+1) [1 + eta * (p + col_k)],

with the physical (Ti, Tn, rows, cols) fault and variation fields
gathered into the logical (I, N, K) layout through the plan.
"""
from __future__ import annotations

import torch

from repro_torch.core.bitslice import bitslice
from repro_torch.core.mdm import MdmPlan, plan_from_bits
from repro_torch.core.noise import PAPER_ETA
from repro_torch.core.tiling import CrossbarSpec
from repro_torch.nonideal.models import NonidealModel, cell_values


def gather_physical(field: torch.Tensor, plan: MdmPlan, spec: CrossbarSpec,
                    I: int, N: int) -> torch.Tensor:
    """A physical (Ti, Tn, rows, cols) field in logical (I, N, K) layout:
    bit (i, n, k) at physical row ``row_position[i // rows, n // wpt,
    i % rows]`` and column ``slot * K + k`` (mirrored when the dataflow
    is reversed, then through ``col_position`` when the plan has it)."""
    rows, wpt, K = spec.rows, spec.weights_per_tile, spec.n_bits
    dev = field.device
    i = torch.arange(I, device=dev)
    n = torch.arange(N, device=dev)
    ti, q, tn = i // rows, i % rows, n // wpt
    p = plan.row_position.to(dev, torch.int64)[ti, :, q][:, tn]
    col = (n % wpt)[:, None] * K + torch.arange(K, device=dev)[None, :]
    if plan.reversed_dataflow:
        col = (spec.cols - 1) - col
    if plan.col_position is not None:
        col = plan.col_position.to(dev, torch.int64)[
            ti[:, None, None], tn[None, :, None], col[None, :, :]]
    else:
        col = col[None, :, :]
    return field[ti[:, None, None], tn[None, :, None], p[:, :, None], col]


def nonideal_magnitude(bits: torch.Tensor, scale: torch.Tensor,
                       plan: MdmPlan, spec: CrossbarSpec, eta: float,
                       stuck: torch.Tensor | None = None,
                       gamma: torch.Tensor | None = None,
                       model: NonidealModel | None = None) -> torch.Tensor:
    """Effective |W'| (I, N) under PR distortion and cell nonidealities;
    with ``stuck`` and ``gamma`` None it is ``noisy_magnitude``."""
    I, N, K = bits.shape
    rows, wpt = spec.rows, spec.weights_per_tile
    dev = bits.device
    f32 = torch.float32
    stuck_log = (torch.zeros((1, 1, 1), dtype=torch.int8, device=dev)
                 if stuck is None else gather_physical(stuck, plan, spec, I, N))
    gamma_log = (torch.ones((1, 1, 1), dtype=f32, device=dev)
                 if gamma is None else gather_physical(gamma, plan, spec, I, N))
    c = cell_values(bits, stuck_log, gamma_log, model)          # (I, N, K)
    bw = 2.0 ** -(1.0 + torch.arange(K, dtype=f32, device=dev))
    n = torch.arange(N, device=dev)
    col = (n % wpt)[:, None] * K + torch.arange(K, device=dev)[None, :]
    if plan.reversed_dataflow:
        col = (spec.cols - 1) - col
    i = torch.arange(I, device=dev)
    ti, tn = i // rows, n // wpt
    p = plan.row_position[ti, :, i % rows][:, tn].to(f32)
    m0 = torch.einsum("ink,k->in", c, bw)
    if plan.col_position is None:
        m1 = torch.einsum("ink,nk->in", c, bw * col.to(f32))
    else:
        colp = plan.col_position[ti[:, None, None], tn[None, :, None],
                                 col[None, :, :]].to(f32)
        m1 = torch.einsum("ink,ink->in", c, bw * colp)
    return scale * ((1.0 + eta * p) * m0 + eta * m1)


def nonideal_weights(w: torch.Tensor, spec: CrossbarSpec, mode="mdm",
                     eta: float = PAPER_ETA,
                     stuck: torch.Tensor | None = None,
                     gamma: torch.Tensor | None = None,
                     model: NonidealModel | None = None,
                     plan: MdmPlan | None = None,
                     fault_aware: bool = False):
    """Bit-slice, plan and distort under faults and variation; returns
    (W' (I, N) f32, plan).  ``fault_aware`` folds ``stuck`` into the
    planning; otherwise only the evaluation sees the faults."""
    sliced = bitslice(w, spec.n_bits)
    if plan is None:
        plan = plan_from_bits(sliced.bits, sliced.scale, spec, mode,
                              stuck if fault_aware else None)
    mag = nonideal_magnitude(sliced.bits, sliced.scale, plan, spec, eta,
                             stuck, gamma, model)
    return mag * sliced.sign.to(torch.float32), plan
