"""Circuit-level resistive-mesh solver: the repo's SPICE replacement.

Port of ``repro.crossbar.solver``.  Nodal analysis of a (J, K)
memristive crossbar with parasitic wire resistance ``r`` per segment
(paper §III-B, Fig 2):

* wordline nodes W[j,k]; row j driven by V_in[j] through r into W[j,0];
* bitline nodes B[j,k]; column k sensed at virtual ground through r
  from B[0,k] (row 0 is the side nearest the output rail, the
  Manhattan-distance convention of ``repro_torch.core.manhattan``);
* a memristor of conductance g[j,k] bridges W[j,k] and B[j,k].

The SPD system is solved by preconditioned CG whose matvec is a pure
stencil (O(JK) an iteration); the dense nodal solve
:func:`column_currents_dense` (numpy) is the oracle for small tiles.
Everything runs in float64 (``torch.float64`` throughout; the NF
signal is ~1e-3 relative).

This module is the single-tile path: :func:`solve_crossbar` is a
Jacobi-preconditioned CG with ``jax.scipy.sparse.linalg.cg``'s stopping
rule (||r|| <= 1e-12 ||b||), run by the batched engine's loop on a batch
of one.  Batches go to :mod:`repro_torch.crossbar.batched`, to which
:func:`measured_nf` routes batched inputs and non-f64 precision
policies.  Entry points take ``device`` (default the card); inputs that
are tensors must lie there.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.tiling import CrossbarSpec
from repro_torch.device import check_on, resolve_device
from repro_torch.kernels.line_solve.ref import line_diagonals

F64 = torch.float64


class SolveResult(NamedTuple):
    currents: torch.Tensor   # (K,) actual column currents under PR
    ideal: torch.Tensor      # (K,) ideal currents (r = 0)
    nf_cols: torch.Tensor    # (K,) per-column |di / i0|
    nf_total: torch.Tensor   # scalar aggregate |sum di| / sum i0
    residual: torch.Tensor   # final relative residual ||A x - b|| / ||b||


def as_tensor(x, dev: torch.device, dtype=None) -> torch.Tensor:
    """``x`` as a tensor on ``dev`` (in ``dtype`` when given); a tensor
    must already lie there."""
    if isinstance(x, torch.Tensor):
        check_on(dev, input=x)
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(np.array(x), dtype=dtype, device=dev)


def mask_conductances(active: torch.Tensor, r_on: float,
                      r_off: float) -> torch.Tensor:
    """1/r_on where ``active`` > 0, else 1/r_off, in f64."""
    on = torch.tensor(1.0 / r_on, dtype=F64, device=active.device)
    off = torch.tensor(1.0 / r_off, dtype=F64, device=active.device)
    return torch.where(active > 0, on, off)


def conductances(active: torch.Tensor, spec: CrossbarSpec) -> torch.Tensor:
    """Cell conductances of activity masks, f64."""
    return mask_conductances(active, spec.r_on, spec.r_off)


def ideal_currents(g: torch.Tensor, v_in: torch.Tensor) -> torch.Tensor:
    """Column currents for r = 0: i_k = sum_j g[..., j, k] v_in[..., j]."""
    return torch.einsum("...jk,...j->...k", g, v_in)


def _stencil_matvec(g: torch.Tensor, cw, x: torch.Tensor) -> torch.Tensor:
    """A @ x for the nodal system: x (..., 2, J, K) stacked [W, B] grids
    over conductances g (..., J, K)."""
    W, B = x[..., 0, :, :], x[..., 1, :, :]
    J, K = W.shape[-2:]
    # Wordline: the left tie is the source (k = 0) or a neighbour; a
    # right tie where k < K-1.
    left = F.pad(W[..., :-1], (1, 0))
    right = F.pad(W[..., 1:], (0, 1))
    deg_w = 1.0 + (torch.arange(K, device=x.device) < K - 1).to(x.dtype)
    y_w = cw * (deg_w * W - left - right) + g * (W - B)
    # Bitline: the down tie is ground (j = 0) or a neighbour; an up tie
    # where j < J-1.
    down = F.pad(B[..., :-1, :], (0, 0, 1, 0))
    up = F.pad(B[..., 1:, :], (0, 0, 0, 1))
    deg_b = 1.0 + (torch.arange(J, device=x.device) < J - 1).to(x.dtype)
    y_b = cw * (deg_b[:, None] * B - down - up) + g * (B - W)
    return torch.stack([y_w, y_b], dim=-3)


def _rhs(v_in: torch.Tensor, cw, K: int) -> torch.Tensor:
    """The drive (..., 2, J, K): cw v_in[j] into W[j, 0]."""
    b = torch.zeros(v_in.shape[:-1] + (2, v_in.shape[-1], K),
                    dtype=v_in.dtype, device=v_in.device)
    b[..., 0, :, 0] = cw * v_in
    return b


_jacobi_diag = line_diagonals


def _currents(x, cw, ideal):
    """(currents, ideal, nf_cols, nf_total) of node voltages x
    (..., 2, J, K) against the ideal currents (..., K)."""
    currents = cw * x[..., 1, 0, :]                 # (B[0,k] - 0) / r
    di = currents - ideal
    nf_cols = di.abs() / ideal.clamp_min(1e-30)
    nf_total = di.sum(-1).abs() / ideal.sum(-1).clamp_min(1e-30)
    return currents, ideal, nf_cols, nf_total


def solve_crossbar(active, v_in, spec_arr, maxiter: int = 4000, *,
                   device: str | torch.device = "cuda") -> SolveResult:
    """Solve one tile with Jacobi-preconditioned CG to ||r|| <= 1e-12
    ||b||.  ``spec_arr`` = (r, r_on, r_off), so one solver serves sweeps
    over device parameters."""
    from repro_torch.crossbar.batched import _pcg_loop

    dev = resolve_device(device)
    active = as_tensor(active, dev)
    v_in = as_tensor(v_in, dev, F64)
    r, r_on, r_off = (float(s) for s in spec_arr)
    g = mask_conductances(active, r_on, r_off)
    cw = 1.0 / r
    b = _rhs(v_in, cw, g.shape[-1])
    x, _, _ = _pcg_loop(g[None], cw, b[None], None, 1e-12, maxiter,
                        "jacobi")
    x = x[0]
    resid = torch.linalg.vector_norm(_stencil_matvec(g, cw, x) - b) \
        / torch.linalg.vector_norm(b)
    return SolveResult(*_currents(x, cw, ideal_currents(g, v_in)), resid)


def _spec_arr(spec: CrossbarSpec) -> tuple[float, float, float]:
    return (spec.r, spec.r_on, spec.r_off)


def _drive(v_in, J: int, spec: CrossbarSpec, dev) -> torch.Tensor:
    """``v_in`` in f64 on ``dev``, by default v_read on every row."""
    if v_in is None:
        return torch.full((J,), spec.v_read, dtype=F64, device=dev)
    return as_tensor(v_in, dev, F64)


def measured_nf(active, spec: CrossbarSpec, v_in=None, maxiter: int = 4000,
                precision=None, *, device: str | torch.device = "cuda"):
    """Circuit-measured NF of one tile (or a batch over leading dims).

    The quantity the paper probes in SPICE; comparing it with
    ``repro_torch.core.manhattan.nonideality_factor`` is the Fig-4
    experiment.  Batched inputs go to the batched engine; a single tile
    under a non-f64 ``precision`` goes there as a batch of one and comes
    back as a :class:`SolveResult`."""
    from repro_torch.crossbar.batched import (
        F64 as P64,
        measured_nf_batched,
        resolve_precision,
    )

    if active.ndim > 2:
        return measured_nf_batched(active, spec, v_in, maxiter, precision,
                                   device=device)
    if precision is not None and resolve_precision(precision) != P64:
        res = measured_nf_batched(active[None], spec, v_in, maxiter,
                                  precision, device=device)
        return SolveResult(*(f[0] for f in res[:5]))
    dev = resolve_device(device)
    return solve_crossbar(active, _drive(v_in, active.shape[-2], spec, dev),
                          _spec_arr(spec), maxiter, device=dev)


def measured_nf_checked(active, spec: CrossbarSpec, v_in=None,
                        maxiter: int = 4000, precision=None,
                        tol: float = 1e-12, escalate: bool = True, *,
                        device: str | torch.device = "cuda"):
    """:func:`measured_nf` with the convergence watchdog: every shape
    goes through ``measured_nf_batched_checked``; returns (result,
    SolverReport), a single (J, K) tile as a :class:`SolveResult` with a
    scalar ``converged``."""
    from repro_torch.crossbar.batched import measured_nf_batched_checked

    res, report = measured_nf_batched_checked(
        active, spec, v_in, maxiter, precision, tol=tol, escalate=escalate,
        device=device)
    if active.ndim > 2:
        return res, report
    return SolveResult(*res[:5]), report


def measured_nf_sequential(active, spec: CrossbarSpec, v_in=None,
                           maxiter: int = 4000, *,
                           device: str | torch.device = "cuda"):
    """One Jacobi CG a tile, tile after tile: the baseline the batched
    engine is compared with (throughput, equivalence tests).  Fields
    carry ``active``'s leading dims."""
    dev = resolve_device(device)
    active = as_tensor(active, dev)
    v = _drive(v_in, active.shape[-2], spec, dev)
    lead = active.shape[:-2]
    flat = active.reshape((-1,) + active.shape[-2:])
    res = [solve_crossbar(a, v, _spec_arr(spec), maxiter, device=dev)
           for a in flat]
    return SolveResult(*(torch.stack(f).reshape(lead + f[0].shape)
                         for f in zip(*res)))


# ----------------------------- dense oracle ------------------------------

def column_currents_dense(active: np.ndarray, v_in: np.ndarray,
                          spec: CrossbarSpec) -> np.ndarray:
    """Dense nodal-matrix solve (numpy, float64): the oracle for small
    tiles.  Node (grid, j, k) is row grid * J K + j K + k."""
    J, K = active.shape
    JK = J * K
    cw = 1.0 / spec.r
    g = np.where(np.asarray(active) > 0, 1.0 / spec.r_on, 1.0 / spec.r_off)
    A = np.zeros((2 * JK, 2 * JK))
    b = np.zeros(2 * JK)

    def tie(a: int, c: int, cond: float) -> None:
        A[a, a] += cond
        A[c, c] += cond
        A[a, c] -= cond
        A[c, a] -= cond

    for j in range(J):
        for k in range(K):
            w, bb = j * K + k, JK + j * K + k
            tie(w, bb, g[j, k])                    # the device
            if k == 0:                             # wordline source tie
                A[w, w] += cw
                b[w] += cw * v_in[j]
            else:
                tie(w, w - 1, cw)
            if j == 0:                             # bitline to ground
                A[bb, bb] += cw
            else:
                tie(bb, bb - K, cw)
    x = np.linalg.solve(A, b)
    return cw * x[JK:].reshape(J, K)[0]
