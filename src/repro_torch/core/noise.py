"""Position-dependent PR distortion (paper Eq 17), materialised.

Port of ``repro.core.noise`` (``noisy_magnitude``, ``noisy_weights``,
``tree_noisy_weights``, and ``calibrate_eta`` against the circuit
solver), the oracle that ``kernels/cim_mvm/ref.py::cim_mvm_ref`` builds
on:

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


def calibrate_eta(spec: CrossbarSpec, key: int = 0, n_tiles: int = 16,
                  sparsity: float = 0.8, precision=None, *,
                  device: str | torch.device = "cuda") -> float:
    """Calibrate eta against the circuit solver (paper §V-C: the paper
    does this in SPICE and finds eta = 2e-3 for r = 2.5 ohm).

    Random (n_tiles, rows, cols) masks of the given sparsity, drawn from
    a torch generator seeded with ``key``, are solved in one batched
    call (``precision``: a ``repro_torch.crossbar.SolverPrecision``, its
    name, or None for f64), and eta is the least-squares fit of the
    Eq-17 deficit ``eta * sum_cells d(j, k)`` to the measured |sum di|
    per cell current (:func:`_fit_eta`)."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    u = torch.rand((n_tiles, spec.rows, spec.cols), device=dev,
                   generator=torch.Generator(dev).manual_seed(int(key)))
    return _fit_eta((u < (1 - sparsity)).to(torch.float32), spec, precision,
                   device=dev)


def _fit_eta(masks: torch.Tensor, spec: CrossbarSpec, precision=None, *,
            device: str | torch.device = "cuda") -> float:
    """The least-squares eta of :func:`calibrate_eta` on given masks
    (T, rows, cols): measured ~= eta * predicted, with measured the
    circuit's sum of |di| over the cell current v_read / r_on and
    predicted the tile's aggregate Manhattan distance."""
    from repro_torch.core.manhattan import aggregate_distance
    from repro_torch.crossbar.batched import measured_nf_batched

    res = measured_nf_batched(masks, spec, precision=precision,
                              device=device)
    i_cell = spec.v_read / spec.r_on
    measured = ((res.currents - res.ideal).abs().sum(-1) / i_cell)
    predicted = aggregate_distance(torch.as_tensor(masks, device=device)
                                   ).to(torch.float64)
    return float((measured * predicted).sum()
                 / (predicted ** 2).sum().clamp_min(1e-30))
