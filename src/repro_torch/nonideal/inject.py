"""Fault and variation injection into CIM deployments, on the device.

Port of ``repro.nonideal.inject`` (whose functions run on the host in
numpy; here they run on the deployment's device, the names kept):

* stuck-at faults fold into the int16 codes exactly, ``(code | on) &
  ~off`` a bit plane (:func:`perturb_codes_host`);
* programming variation and drift fold into a per-weight ``gain`` =
  M0' / M0 (:func:`variation_gain_host`, :func:`aged_gain_host`), exact
  for the clean-magnitude term of Eq 17 (the exact evaluator is
  :mod:`repro_torch.nonideal.weights`);
* programmed bits left on OPEN cells after the remap
  (:func:`open_bit_overlap_host`) mark the deployment ``degraded``.

**Sampling is per matrix.**  The reference draws one fused population
for the whole checkpoint; at phi3-mini's width that is 29 G cells (29 GB
of int8 codes and 116 GB of f32 gains), so here each matrix draws its
own cells from a key derived from (seed, its traversal index)
(:func:`matrix_cells`), a function of (seed, index, model) alone, and
the deployment engine draws, uses and frees one matrix at a time.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch

from repro_torch.core.tiling import CrossbarSpec
from repro_torch.device import resolve_device
from repro_torch.nonideal.models import (
    HEALTHY,
    OPEN,
    STUCK_OFF,
    STUCK_ON,
    NonidealModel,
    derive_key,
    sample_cell_state,
    sample_stuck_state,
)

# The reprogram draws' tag under (key, index): outside the samplers'
# term tags (0-5), as the reference's fold_in branch 7.
TAG_REPROGRAM = 7


class HostCells(NamedTuple):
    """One matrix's sampled physical cell state (the reference's name; the
    tensors live on the deployment's device).

    stuck: (Ti, Tn, rows, cols) int8 cell codes, or None (no faults).
    gamma: (Ti, Tn, rows, cols) f32 programming gains, or None.
    relax: (Ti, Tn, rows, cols) f32 unit-normal relaxation draws, or None.
    """

    stuck: torch.Tensor | None
    gamma: torch.Tensor | None
    relax: torch.Tensor | None = None


def cells_on(c, device) -> HostCells:
    """Cells (fields ``stuck``, ``gamma``, ``relax``: numpy arrays, the
    reference's, or tensors) on ``device``."""
    move = lambda f: None if f is None else (
        f if isinstance(f, torch.Tensor)
        else torch.from_numpy(np.array(f, copy=True))).to(device)
    return HostCells(move(c.stuck), move(c.gamma),
                     move(getattr(c, "relax", None)))


def has_faults(model: NonidealModel) -> bool:
    return (model.p_stuck_off > 0.0 or model.p_stuck_on > 0.0
            or model.has_line_opens)


def has_gain(model: NonidealModel) -> bool:
    return (model.sigma_program > 0.0 or model.drift_factor != 1.0
            or model.sigma_corr > 0.0 or model.has_aging)


def matrix_cells(key: int, index: int, grid: tuple[int, int],
                 spec: CrossbarSpec, model: NonidealModel,
                 device="cuda") -> HostCells:
    """The cells of the ``index``-th matrix (traversal order) of a
    deployment keyed by ``key``, on ``device``; fields the model does
    not perturb are None, as the reference's."""
    device = resolve_device(device)
    ti, tn = grid
    s = sample_cell_state(derive_key(key, index),
                          (ti, tn, spec.rows, spec.cols), model,
                          device=device, read=False)
    return HostCells(s.stuck if has_faults(model) else None,
                     s.gamma if has_gain(model) else None,
                     s.relax if model.sigma_relax > 0.0 else None)


def reprogram_cells(key: int, index: int, n: int, grid: tuple[int, int],
                    spec: CrossbarSpec, model: NonidealModel,
                    stuck: torch.Tensor | None, device="cuda") -> HostCells:
    """The cells of the ``index``-th matrix after its ``n``-th reprogram
    (n >= 1): fresh variation and relaxation drawn from (key, index,
    ``TAG_REPROGRAM``, n), the deploy's ``stuck`` map pinned (defects
    are hardware).  The reference keys the same draw by ``fold_in(key,
    n)``, a stream torch cannot reproduce."""
    device = resolve_device(device)
    ti, tn = grid
    s = sample_cell_state(derive_key(key, index, TAG_REPROGRAM, n),
                          (ti, tn, spec.rows, spec.cols), model,
                          stuck=stuck, device=device, read=False)
    return HostCells(stuck, s.gamma if has_gain(model) else None,
                     s.relax if model.sigma_relax > 0.0 else None)


def matrix_stuck(key: int, index: int, grid: tuple[int, int],
                 spec: CrossbarSpec, model: NonidealModel,
                 device="cuda") -> torch.Tensor:
    """The ``stuck`` field of :func:`matrix_cells` alone (the planner's
    fault map), without drawing the variation terms."""
    device = resolve_device(device)
    ti, tn = grid
    return sample_stuck_state(derive_key(key, index),
                              (ti, tn, spec.rows, spec.cols), model, device)


def sample_deployment_cells(key: int, grids: Mapping[str, tuple[int, int]],
                            spec: CrossbarSpec, model: NonidealModel,
                            device="cuda") -> dict[str, HostCells]:
    """The physical cell state of every matrix of ``grids`` (name ->
    (Ti, Tn)), in its iteration order: :func:`matrix_cells` each."""
    device = resolve_device(device)
    return {name: matrix_cells(key, t, grid, spec, model, device)
            for t, (name, grid) in enumerate(grids.items())}


def gather_physical_host(field: torch.Tensor, row_position: torch.Tensor,
                         reversed_df: bool, spec: CrossbarSpec,
                         col_position: torch.Tensor | None = None,
                         rows_slice: slice | None = None) -> torch.Tensor:
    """A physical (Ti, Tn, rows, cols) field in the logical (I_pad,
    N_pad, K) layout of a plan: bit (i, n, k) sits at physical row
    ``row_position[i // rows, n // wpt, i % rows]`` and column
    ``slot * K + k`` (mirrored under reversed dataflow, then through
    ``col_position`` when given).  ``rows_slice`` gathers only those
    logical rows (the engine works a few tiles of rows at a time)."""
    ti_n, tn_n = field.shape[0], field.shape[1]
    rows, cols, wpt, K = spec.rows, spec.cols, spec.weights_per_tile, \
        spec.n_bits
    dev = field.device
    i = torch.arange(ti_n * rows, device=dev)
    if rows_slice is not None:
        i = i[rows_slice]
    n = torch.arange(tn_n * wpt, device=dev)
    ti, q, tn = i // rows, i % rows, n // wpt
    p = row_position.to(dev, torch.int64)[ti, :, q][:, tn]      # (I, N)
    col = (n % wpt)[:, None] * K + torch.arange(K, device=dev)  # (N, K)
    if reversed_df:
        col = (cols - 1) - col
    tile = ti[:, None] * tn_n + tn[None, :]                    # (I, N)
    if col_position is not None:
        col = col_position.to(dev, torch.int64).reshape(-1, cols)[
            tile[:, :, None], col[None, :, :]]                  # (I, N, K)
    flat = ((tile * rows + p) * cols)[:, :, None] + col
    return field.reshape(-1)[flat]


def _shifts(n_bits: int, device) -> torch.Tensor:
    """Shift of bit plane k in a code: n_bits - 1 - k (high-order first)."""
    return n_bits - 1 - torch.arange(n_bits, device=device, dtype=torch.int32)


def perturb_codes_host(codes: torch.Tensor, stuck_log: torch.Tensor,
                       n_bits: int) -> torch.Tensor:
    """Stuck bits applied to (I, N) int32 magnitude codes: a stuck-ON
    cell reads 1, stuck-OFF and OPEN cells read 0 (``stuck_log`` in the
    logical (I, N, K) layout)."""
    sh = _shifts(n_bits, codes.device)
    on = ((stuck_log == STUCK_ON).to(torch.int32) << sh).sum(-1)
    off = (((stuck_log == STUCK_OFF) | (stuck_log == OPEN))
           .to(torch.int32) << sh).sum(-1)
    return (codes | on) & ~off


def _bits(codes: torch.Tensor, n_bits: int) -> torch.Tensor:
    return (codes[..., None] >> _shifts(n_bits, codes.device)) & 1


def open_bit_overlap_host(codes: torch.Tensor, stuck_log: torch.Tensor,
                          n_bits: int) -> int:
    """Programmed bits (1s of the codes) on OPEN cells: 0 when the remap
    absorbed every open line, else the deployment is degraded.
    Evaluate before :func:`perturb_codes_host`, which clears them."""
    return int(((_bits(codes, n_bits) == 1) & (stuck_log == OPEN)).sum())


def variation_gain_host(codes: torch.Tensor, stuck_log: torch.Tensor | None,
                        gamma_log: torch.Tensor, n_bits: int,
                        drift_factor: float = 1.0) -> torch.Tensor:
    """Per-weight gain M0' / M0 with ``M0' = sum_k gamma_eff_k b_k
    2^-(k+1)`` over the (stuck-perturbed) bits; stuck cells carry gain 1
    and a weight with no programmed bit gain 1.  f32."""
    f32 = torch.float32
    bits = _bits(codes, n_bits).to(f32)
    bw = 2.0 ** -(1.0 + torch.arange(n_bits, dtype=f32, device=codes.device))
    g_eff = gamma_log.to(f32) * torch.tensor(drift_factor, dtype=f32,
                                              device=codes.device)
    if stuck_log is not None:
        g_eff = torch.where(stuck_log != HEALTHY, 1.0, g_eff)
    m0 = (bits * bw).sum(-1)
    m0p = (bits * g_eff * bw).sum(-1)
    return torch.where(m0 > 0, m0p / torch.clamp(m0, min=1e-30),
                       torch.ones((), dtype=f32, device=codes.device))


def aged_gain_host(codes: torch.Tensor, stuck_log: torch.Tensor | None,
                   gamma_log: torch.Tensor | None,
                   relax_log: torch.Tensor | None, n_bits: int,
                   model: NonidealModel, age: float) -> torch.Tensor:
    """:func:`variation_gain_host` with drift and relaxation evaluated at
    runtime ``age`` (the relaxation draw scaled by
    ``relax_sigma_at(age)``)."""
    g = (torch.ones(codes.shape + (n_bits,), dtype=torch.float32,
                    device=codes.device)
         if gamma_log is None else gamma_log.to(torch.float32))
    s_relax = model.relax_sigma_at(age)
    if relax_log is not None and s_relax > 0.0:
        g = g * torch.exp(torch.tensor(s_relax, dtype=torch.float32,
                                       device=codes.device)
                          * relax_log.to(torch.float32))
    return variation_gain_host(codes, stuck_log, g, n_bits,
                               model.drift_factor_at(age))
